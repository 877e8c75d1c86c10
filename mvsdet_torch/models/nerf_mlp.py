"""NeRF MLPs of the legacy NeRF-Det supervision branch (port of
mvsdet_tpu/models/nerf_mlp.py; reference:
projects/NeRF-Det/nerfdet/nerf_utils/nerf_mlp.py):

  - `sinusoidal_encode`, the positional encoding (ref :202-230)
  - `SkipMLP`, a ReLU MLP with a skip connection (`NerfMLP`, ref :13-113)
  - `VanillaNeRF`, the encoders, the sigma and rgb heads (ref :232-277)

NeRF-Det builds VanillaNeRF(net_depth=4, net_width=256, skip_layer=3,
feature_dim=nerf_feature_dim + 6) (nerfdet.py:97-103).  The submodules
carry the flax names (`base.hidden{i}`, `sigma`, `bottleneck`,
`rgb.hidden0`, `rgb.output`), so the weight bridge maps the JAX tree
onto them.  Every dense layer is `layers.Linear`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mvsdet_torch.models.layers import Linear, sigmoid


def sinusoidal_encode(x: torch.Tensor, min_deg: int, max_deg: int,
                      use_identity: bool = True) -> torch.Tensor:
    """NeRF positional encoding (nerf_mlp.py:219-230), laid out as the JAX
    function lays it out: x scaled by 2^min_deg .. 2^(max_deg-1), degree
    major, then sin of [xb, xb + pi/2] (sin of the shifted value, not
    cos, so that the last bits match), after x itself."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        x.shape[:-1] + ((max_deg - min_deg) * x.shape[-1],))
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


def encode_dim(x_dim: int, min_deg: int, max_deg: int,
               use_identity: bool = True) -> int:
    """The width `sinusoidal_encode` gives an input of width ``x_dim``."""
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim


class SkipMLP(nn.Module):
    """ReLU MLP that appends its input after hidden layer i where
    ``i % skip_layer == 0 and i > 0`` (nerf_mlp.py:13-113): with 4 layers
    and skip 3, after the last one, so its output is net_width + in_dim
    wide.  With ``output_dim`` a linear `output` layer follows."""

    def __init__(self, in_dim: int, net_depth: int = 8, net_width: int = 256,
                 skip_layer: Optional[int] = 4, output_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net_depth = net_depth
        self.skip_layer = skip_layer
        self.output_dim = output_dim
        width = in_dim
        for i in range(net_depth):
            setattr(self, f"hidden{i}", Linear(width, net_width, dtype=dtype))
            width = net_width
            if self._skips(i):
                width += in_dim
        self.out_dim = width
        if output_dim > 0:
            self.output = Linear(width, output_dim, dtype=dtype)
            self.out_dim = output_dim

    def _skips(self, i: int) -> bool:
        return (self.skip_layer is not None and i % self.skip_layer == 0
                and i > 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(self.net_depth):
            x = torch.relu(getattr(self, f"hidden{i}")(x))
            if self._skips(i):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_dim > 0:
            x = self.output(x)
        return x


class VanillaNeRF(nn.Module):
    """Positional-encoded NeRF MLP returning (rgb, sigma)
    (`VanillaNeRF`, nerf_mlp.py:232-277): points encoded at degrees 0-10,
    ray directions at 0-4; sigma = relu(sigma(hidden)), rgb =
    sigmoid(rgb([bottleneck(hidden), view encoding])), the view encoding
    broadcast over the samples of its ray."""

    def __init__(self, net_depth: int = 4, net_width: int = 256,
                 skip_layer: int = 3, feature_dim: int = 0,
                 net_depth_condition: int = 1, net_width_condition: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        in_dim = encode_dim(3, 0, 10) + feature_dim
        self.base = SkipMLP(in_dim, net_depth=net_depth, net_width=net_width,
                            skip_layer=skip_layer, dtype=dtype)
        hidden = self.base.out_dim
        self.sigma = Linear(hidden, 1, dtype=dtype)
        self.bottleneck = Linear(hidden, net_width, dtype=dtype)
        self.rgb = SkipMLP(net_width + encode_dim(3, 0, 4),
                           net_depth=net_depth_condition,
                           net_width=net_width_condition, skip_layer=None,
                           output_dim=3, dtype=dtype)

    def _hidden(self, points: torch.Tensor,
                features: Optional[torch.Tensor]) -> torch.Tensor:
        x = sinusoidal_encode(points, 0, 10)
        if features is not None:
            x = torch.cat([x, features], dim=-1)
        return self.base(x)

    def query_density(self, points: torch.Tensor,
                      features: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The relu'd raw sigma (nerf_mlp.py:267-270), (..., 1)."""
        return torch.relu(self.sigma(self._hidden(points, features)))

    def forward(self, points: torch.Tensor, view_dirs: torch.Tensor,
                features: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points (..., 3), view_dirs (..., 3) or one per ray, (R, 3) for
        points (R, S, 3), features (..., F) -> rgb (..., 3), sigma
        (..., 1).  The JAX module also takes no view directions, and then
        builds its rgb MLP on the hidden features, another width; NeRF-Det
        always gives them, and so the port's rgb MLP takes the bottleneck
        and the view encoding only."""
        h = self._hidden(points, features)
        sigma = torch.relu(self.sigma(h))
        cond = sinusoidal_encode(view_dirs, 0, 4)
        if cond.ndim < h.ndim:
            cond = cond[..., None, :].expand(h.shape[:-1] + (cond.shape[-1],))
        rgb = self.rgb(torch.cat([self.bottleneck(h), cond], dim=-1))
        return sigmoid(rgb), sigma
