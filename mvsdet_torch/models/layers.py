"""Shared building blocks (port of mvsdet_tpu/models/layers.py).

Channels-first activations, (N, C, H, W) and (N, C, D, H, W), as cuDNN
wants them; the conv blocks are the 3D ones the cost regulariser and the
neck use.  Submodule names follow the JAX package's parameter tree
(`conv`, `norm` for its auto-named `Conv_0`/`GroupNorm_0`/...), so the
weight bridge in `mvsdet_torch/interop.py` is a renaming.
"""

from __future__ import annotations

import torch
from torch import nn


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
        return x * inv.reshape(shape) + b.reshape(shape)


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
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.ndim))
        mean = x.mean(dim=dims)
        var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


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
        self.conv = nn.Conv3d(in_channels, features, kernel, stride,
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
        self.conv = nn.ConvTranspose3d(in_channels, features, kernel,
                                       stride=2, padding=p,
                                       output_padding=2 * p - kernel + 2,
                                       bias=False)
        self.norm = _norm_layer(norm, features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.norm(self.conv(x), train))
