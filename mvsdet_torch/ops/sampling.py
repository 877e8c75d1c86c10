"""Bilinear sampling and resizing (port of mvsdet_tpu/ops/sampling.py).

`bilinear_sample` gathers rows of a channels-last (H*W, C) map, as the
JAX package does.  The resizers reproduce `jax.image.resize` exactly,
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

from mvsdet_torch.utils.precision import feinsum


def torch_grid_sample_skew(coords: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """Map intended pixel coordinates to the ones the reference's
    `grid_sample` taps (mvsdet_tpu/ops/sampling.py:22-45).

    The reference normalises by (size - 1) / 2 (align_corners=True,
    module.py:137-138) but samples with align_corners=False, so a
    coordinate p is fetched at p * size / (size - 1) - 0.5.  Only the
    torch-golden parity of `homography_warp(torch_compat=True)` uses it.

    Args:
      coords: (..., 2) intended (x, y) pixel coordinates.

    Returns:
      (..., 2) the coordinates `grid_sample` effectively taps.
    """
    x = coords[..., 0] * (width / (width - 1)) - 0.5
    y = coords[..., 1] * (height / (height - 1)) - 0.5
    return torch.stack([x, y], dim=-1)


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample channels-last images at pixel coordinates.

    Zero padding outside the image (padding_mode='zeros').

    Args:
      image: (B, H, W, C).
      coords: (B, ..., 2) pixel coordinates in (x, y) order; integer values
        hit pixel centres.

    Returns:
      (B, ..., C) sampled values.
    """
    b, h, w, c = image.shape
    x, y = coords[..., 0], coords[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = x - x0f
    wy1 = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = image.reshape(b * h * w, c)
    base = (torch.arange(b, device=image.device) * (h * w)).reshape(
        (b,) + (1,) * (coords.ndim - 2))

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (c,))
        return vals * (wgt * valid.to(image.dtype))[..., None]

    return (tap(x0, y0, (1 - wx1) * (1 - wy1))
            + tap(x0 + 1, y0, wx1 * (1 - wy1))
            + tap(x0, y0 + 1, (1 - wx1) * wy1)
            + tap(x0 + 1, y0 + 1, wx1 * wy1))


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
