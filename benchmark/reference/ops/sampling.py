# Frozen copy of mvsdet_torch/ops/sampling.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Resizing (port of mvsdet_tpu/ops/sampling.py).

The resizers reproduce `jax.image.resize` exactly,
not `F.interpolate`: the JAX "linear" resize antialiases when it
downsamples (a triangle filter widened by the scale), which torch's
trilinear cannot, and JAX "nearest" takes half-pixel centres, which is
torch's "nearest-exact" only up to float rounding.  So both build their
index or weight tables on the host the way JAX does and apply them here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from benchmark.reference.utils.precision import feinsum


def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of `jax.image.resize(..., "linear")` with
    antialiasing, step for step as `jax._src.image.scale.compute_weight_mat`
    computes them in float32."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(f32)


def linear_resize(x: torch.Tensor, shape: Sequence[int],
                  dims: Sequence[int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "linear")` over the named dims, with its
    antialiasing triangle filter when downsampling.

    Args:
      x: float tensor.
      shape: output sizes, one per entry of ``dims``.
      dims: the axes to resize; axes whose size is unchanged are skipped,
        as JAX skips them.
    """
    for d, n in zip(dims, shape):
        m = x.shape[d]
        if m == n:
            continue
        wmat = torch.as_tensor(_linear_weights(m, n), device=x.device)
        x = torch.movedim(feinsum("...m,mn->...n", torch.movedim(x, d, -1),
                                  wmat), -1, d)
    return x


def bilinear_resize(image: torch.Tensor, out_shape) -> torch.Tensor:
    """Resize channels-last (..., H, W, C) images to (..., H2, W2, C) as
    `jax.image.resize(method="bilinear")` resizes each (H, W, C) image
    (antialiased downsampling, half-pixel centres)."""
    return linear_resize(image, out_shape, (image.ndim - 3, image.ndim - 2))


def nearest_resize(x: torch.Tensor, shape: Sequence[int],
                   dims: Sequence[int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "nearest")` over the named dims: source
    index floor((i + 0.5) * in / out), computed in float32 as JAX does."""
    for d, n in zip(dims, shape):
        m = x.shape[d]
        if m == n:
            continue
        f32 = np.float32
        src = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n))
        x = x.index_select(d, torch.as_tensor(src.astype(np.int64),
                                              device=x.device))
    return x
