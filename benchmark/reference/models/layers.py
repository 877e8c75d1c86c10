# Frozen copy of mvsdet_torch/models/layers.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Shared building blocks (port of mvsdet_tpu/models/layers.py).

Channels-first activations, (N, C, H, W) and (N, C, D, H, W), as cuDNN
wants them; the conv blocks are the 3D ones the cost regulariser and the
neck use.  Submodule names follow the JAX package's parameter tree
(`conv`, `norm` for its auto-named `Conv_0`/`GroupNorm_0`/...), so the
weight bridge in `mvsdet_torch/interop.py` is a renaming.

The benchmark's reference computes in float32 only.  A convolution or
dense layer adds its bias after the product, as flax does.
"""

from __future__ import annotations

import torch
from torch import nn


def _apply(layer: nn.Module, product, x: torch.Tensor) -> torch.Tensor:
    """``product(x, weight)``, then the layer's bias added, channels on
    dim 1 (or last, for a dense layer)."""
    y = product(x, layer.weight)
    if layer.bias is None:
        return y
    shape = (-1,) if isinstance(layer, nn.Linear) \
        else (-1,) + (1,) * (y.ndim - 2)
    return y + layer.bias.reshape(shape)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` with its bias added after the product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply(self, lambda x, w: self._conv_forward(x, w, None), x)


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` with its bias added after the product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply(self, lambda x, w: self._conv_forward(x, w, None), x)


class ConvTranspose3d(nn.ConvTranspose3d):
    """`nn.ConvTranspose3d` (fixed output size), its bias added after the
    product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply(self, lambda x, w: nn.functional.conv_transpose3d(
            x, w, None, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation), x)


class Linear(nn.Linear):
    """`nn.Linear` with its bias added after the product."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _apply(self, nn.functional.linear, x)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA computes it: 1 / (1 + exp(-x)), each op
    rounded, with JAX's derivative y (1 - y)."""
    return _Sigmoid.apply(x)


def _no_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(x), 0.0, x)


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(_no_inf(x) - _no_inf(y))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, logaddexp(x, 0), as JAX computes it: max(x, 0) +
    log1p(exp(-|x|)), each op rounded, with no threshold
    (ROADMAP trap T12; `F.softplus` turns into x above 20), and JAX's
    derivative exp(x - softplus(x))."""
    return _Softplus.apply(x)


def at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """`jnp.maximum(x, lo)`: where x equals lo, half the gradient passes to
    x, as JAX splits a tie (`torch.clamp_min` would pass all of it,
    ROADMAP trap T20)."""
    return torch.maximum(x, x.new_tensor(lo))


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine (buffers, no gradient).

    The reference backbone's BN runs with requires_grad=False and
    norm_eval=True (mvsdet_res50_2x_low_res_depth.py:23-24).  Computed as
    the JAX module does: x * (scale / sqrt(var + eps)) + (bias - mean *
    scale / sqrt(var + eps)).
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * inv
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.reshape(shape) \
            + b.reshape(shape)


def group_size(channels: int) -> int:
    """The JAX GroupNorm's group size: the largest of 8, 4, 2, 1 that
    divides C (layers.py:60-64); torch takes C // group_size groups
    (ROADMAP trap T8)."""
    return max(d for d in (8, 4, 2, 1) if channels % d == 0)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over all axes but 1.

    Eval (`train=False`) normalises with the running statistics.  Train
    normalises with the batch's statistics, computed as flax computes them
    (mean, and var = E[x^2] - E[x]^2 clipped at 0), and moves the running
    statistics 0.1 of the way to them.  The running variance takes the
    biased batch variance, as flax's does; torch's own BatchNorm would
    take the unbiased one, m / (m - 1) larger (ROADMAP trap T4).  The
    update is made in place, once per forward: a forward run twice under
    `torch.utils.checkpoint` would update twice.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var,
                self.weight, self.bias, False, 0.0, self.eps)
        stats = x
        dims = [0] + list(range(2, x.ndim))
        mean = stats.mean(dim=dims)
        var = torch.clamp_min((stats * stats).mean(dim=dims) - mean * mean,
                              0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape))
                * mul.reshape(shape)
                + self.bias.reshape(shape))


class GroupNorm(nn.GroupNorm):
    """GroupNorm that takes (and ignores) the train flag: it normalises
    each sample by itself in train and eval alike."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return super().forward(x)


def _norm_layer(norm: str, channels: int) -> nn.Module:
    """Normalisation of a 3D block: 'batch' is `BatchNorm` (batch statistics
    in train, running ones in eval), 'group' is GroupNorm."""
    if norm == "batch":
        return BatchNorm(channels)
    if norm == "group":
        return GroupNorm(channels // group_size(channels), channels, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


class ConvBnReLU(nn.Module):
    """3D conv (symmetric k//2 padding, no bias) -> Norm -> (ReLU)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, norm: str = "batch"):
        super().__init__()
        self.conv = Conv3d(in_channels, features, kernel, stride,
                           padding=kernel // 2, bias=False)
        self.norm = _norm_layer(norm, features)
        self.relu = relu

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.norm(self.conv(x), train)
        return torch.relu(x) if self.relu else x


class DeconvBnReLU(nn.Module):
    """3D transposed conv (exact 2x upsample) -> Norm -> ReLU.

    torch ConvTranspose3d(k, s=2, p=(k-1)//2, output_padding=2p-k+2): k=3
    p=1 op=1 (mvsnet.py:92-100) or k=2 p=0 op=0 (imvoxel_neck).  flax's
    ConvTranspose does not flip its kernel, so the bridge flips it
    (ROADMAP trap T7).
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 norm: str = "batch"):
        super().__init__()
        p = (kernel - 1) // 2
        self.conv = ConvTranspose3d(in_channels, features, kernel, stride=2,
                                    padding=p,
                                    output_padding=2 * p - kernel + 2,
                                    bias=False)
        self.norm = _norm_layer(norm, features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.norm(self.conv(x), train))
