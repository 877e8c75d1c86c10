# Frozen copy of mvsdet_torch/models/gaussian_head.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Pixel-aligned Gaussian parameter head and adapter (port of
mvsdet_tpu/models/gaussian_head.py; reference: mvsdet.py:210-216,
gs_src/model/encoder/common/gaussian_adapter.py:32-119).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from benchmark.reference.config import GaussianAdapterConfig
from benchmark.reference.geometry.rays import get_world_rays
from benchmark.reference.geometry.sh import rotate_sh
from benchmark.reference.geometry.transforms import build_covariance
from benchmark.reference.models.layers import Linear, sigmoid
from benchmark.reference.utils.precision import feinsum


@dataclasses.dataclass
class Gaussians:
    """World-space Gaussian set (ref: gs_src/model/types.py:7)."""

    means: torch.Tensor        # (..., 3)
    covariances: torch.Tensor  # (..., 3, 3)
    harmonics: torch.Tensor    # (..., 3, d_sh)
    opacities: torch.Tensor    # (...)


class ToGaussians(nn.Module):
    """ReLU -> Linear to raw gaussian parameters (mvsdet.py:210-216)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.proj = Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(torch.relu(x))


def sh_mask(cfg: GaussianAdapterConfig, device=None) -> torch.Tensor:
    """DC-biased SH coefficient mask (gaussian_adapter.py:42-48)."""
    m = torch.ones(cfg.d_sh, dtype=torch.float32, device=device)
    for degree in range(1, cfg.sh_degree + 1):
        m[degree**2:(degree + 1) ** 2] = 0.1 * 0.25**degree
    return m


def scale_multiplier(intrinsics: torch.Tensor, pixel_size: torch.Tensor,
                     multiplier: float = 0.1) -> torch.Tensor:
    """0.1 * sum(inv(K[:2, :2]) @ pixel_size) (gaussian_adapter.py:100-111).

    Args:
      intrinsics: (..., 3, 3) normalised K; pixel_size: (2,) = (1/w, 1/h).
    """
    inv = torch.linalg.inv_ex(intrinsics[..., :2, :2]).inverse
    return (multiplier * feinsum("...ij,j->...i", inv, pixel_size)).sum(-1)


def adapt_gaussians(c2w: torch.Tensor, intrinsics: torch.Tensor,
                    coordinates: torch.Tensor, depths: torch.Tensor,
                    opacities: torch.Tensor, raw: torch.Tensor,
                    image_shape: Tuple[int, int], cfg: GaussianAdapterConfig,
                    eps: float = 1e-8) -> Gaussians:
    """Raw parameters -> world Gaussians (`GaussianAdapter.forward`, :50-98).

    Args:
      c2w: (V, 4, 4); intrinsics: (V, 3, 3) normalised;
      coordinates: (V, R, 2) in (0, 1) incl. offsets; depths: (V, R) ray
      depths; opacities: (V, R); raw: (V, R, d_in) = 3 scale + 4 quat +
      3 * d_sh SH; image_shape: (h, w) of the feature grid.

    Returns:
      Gaussians with leading shape (V, R), float32 whatever raw's dtype:
      the float32 depths, SH mask and c2w promote every output, as in the
      JAX package (the compositor takes float32 tables).
    """
    h, w = image_shape
    scales, rotations, sh = torch.split(raw, [3, 4, raw.shape[-1] - 7],
                                        dim=-1)
    s_min, s_max = cfg.gaussian_scale_min, cfg.gaussian_scale_max
    scales = s_min + (s_max - s_min) * sigmoid(scales)
    pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32,
                              device=raw.device)
    mult = scale_multiplier(intrinsics, pixel_size)           # (V,)
    scales = scales * depths[..., None] * mult[:, None, None]

    # the norm as jnp.linalg.norm takes it
    rotations = rotations / (torch.sqrt(torch.sum(
        rotations * rotations, dim=-1, keepdim=True)) + eps)
    sh = sh.reshape(sh.shape[:-1] + (3, cfg.d_sh)) * sh_mask(cfg, raw.device)

    cov = build_covariance(scales, rotations)                 # (V, R, 3, 3)
    rot_c2w = c2w[:, :3, :3]
    cov = feinsum("vij,vrjk,vlk->vril", rot_c2w, cov, rot_c2w)

    origins, dirs = get_world_rays(coordinates, c2w[:, None],
                                   intrinsics[:, None])
    means = origins + dirs * depths[..., None]
    harmonics = rotate_sh(sh, rot_c2w[:, None, None, :, :])
    return Gaussians(means=means, covariances=cov, harmonics=harmonics,
                     opacities=opacities)
