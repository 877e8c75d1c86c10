"""Ray sampling, multi-view feature aggregation and volume rendering (port
of mvsdet_tpu/ops/ray_render.py; reference:
projects/NeRF-Det/nerfdet/nerf_utils/render_ray.py and projection.py):

  - stratified / inverse-depth ray sampling         (render_ray.py:110-167)
  - hierarchical PDF inversion `sample_pdf`         (:60-107)
  - alpha compositing `raw2outputs` with the repo's
    interval-free sigma2alpha                        (:170-226)
  - multi-view point projection, bilinear feature
    sampling and masked mean/var pooling             (projection.py:9-140,
                                                      render_ray.py:52-58)
  - trilinear volume sampling                        (render_ray.py:15-31)

The random draws are inputs: the caller hands `sample_along_rays` and
`sample_pdf` their uniforms (the JAX functions take a PRNG key and draw
them inside), so that a test can hand over JAX's own draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mvsdet_torch.ops.sampling import bilinear_sample
from mvsdet_torch.utils.precision import feinsum


def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in float32 as JAX computes it:
    start * (1 - i / (num - 1)) + stop * (i / (num - 1)), the last value
    ``stop`` itself (torch.linspace rounds its values otherwise)."""
    f32 = np.float32
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    step = np.arange(num - 1, dtype=f32) / f32(num - 1)
    out = f32(start) * (f32(1) - step) + f32(stop) * step
    return torch.as_tensor(np.append(out, f32(stop)).astype(f32),
                           device=device)


def sample_along_rays(uniforms: Optional[torch.Tensor], ray_o: torch.Tensor,
                      ray_d: torch.Tensor, near: float, far: float,
                      n_samples: int, inv_uniform: bool = False,
                      det: bool = False):
    """Stratified samples along rays (render_ray.py:110-167).

    Args:
      uniforms: (R, S) draws in [0, 1) placing each sample in its stratum
        (unused, and may be None, with ``det``).
      ray_o, ray_d: (R, 3).

    Returns:
      pts (R, S, 3), z_vals (R, S).
    """
    r = ray_o.shape[0]
    if inv_uniform:
        z = 1.0 / linspace(1.0 / near, 1.0 / far, n_samples, ray_o.device)
    else:
        z = linspace(near, far, n_samples, ray_o.device)
    z_vals = z.expand(r, n_samples)
    if not det:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * uniforms
    pts = ray_o[:, None, :] + z_vals[..., None] * ray_d[:, None, :]
    return pts, z_vals


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last dim, left to right in x's dtype, as
    XLA's reduce and reduce_window add on the CPU: torch's CPU cumsum
    accumulates float32 in float64 and its sum in vector lanes, and a cdf
    step near `sample_pdf`'s 1e-5 floor turns such an ulp into 1e-6 of a
    sample's position."""
    acc = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., i])
    return torch.stack(acc, dim=-1)


def sample_pdf(uniforms: Optional[torch.Tensor], bins: torch.Tensor,
               weights: torch.Tensor, n_samples: int,
               det: bool = False) -> torch.Tensor:
    """Inverse-CDF sampling for hierarchical NeRF (render_ray.py:60-107).

    Args:
      uniforms: (R, n_samples) draws in [0, 1) (unused with ``det``, which
        takes linspace(0, 1) on every ray).
      bins, weights: (R, M).

    Returns:
      (R, n_samples) sample positions.
    """
    r, m = weights.shape
    w = weights + 1e-5
    pdf = w / _running_sum(w)[:, -1:]
    cdf = _running_sum(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, M+1)
    if det:
        u = linspace(0.0, 1.0, n_samples, weights.device).expand(r, n_samples)
    else:
        u = uniforms
    above = torch.sum(u[..., None] >= cdf[:, None, :m], dim=-1)  # (R, S)
    below = torch.clamp_min(above - 1, 0)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, torch.clamp_max(below, m - 1))
    bins_a = torch.gather(bins, -1, torch.clamp_max(above, m - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def raw2outputs(rgb: torch.Tensor, sigma: torch.Tensor, z_vals: torch.Tensor,
                white_bkgd: bool = False) -> Dict[str, torch.Tensor]:
    """Composite raw NeRF outputs (render_ray.py:170-226) with the repo's
    interval-free alpha = 1 - exp(-sigma).  The depth is clipped to the
    smallest and largest z of all the rays, as the JAX function clips it,
    with `torch.maximum`/`torch.minimum`, which split a tie's gradient as
    `jnp.clip` does (ROADMAP T20).

    Args:
      rgb: (R, S, 3); sigma, z_vals: (R, S).

    Returns:
      dict(rgb (R, 3), depth (R,), weights (R, S)).
    """
    alpha = 1.0 - torch.exp(-sigma)
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    t = torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=-1)
    weights = alpha * t
    rgb_map = torch.sum(weights[..., None] * rgb, dim=1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    depth = (torch.sum(weights * z_vals, dim=-1)
             / (torch.sum(weights, dim=-1) + 1e-8))
    depth = torch.minimum(torch.maximum(depth, z_vals.min()), z_vals.max())
    return dict(rgb=rgb_map, depth=depth, weights=weights)


def project_to_views(points: torch.Tensor, w2c: torch.Tensor,
                     intrinsic: torch.Tensor):
    """Project world points into every source view
    (`Projector.compute_projections`, projection.py:28-48): pixels through
    K @ w2c, z clamped at 1e-8 and the pixels at +-1e6, and the in-front
    mask.

    Args:
      points: (P, 3); w2c: (V, 4, 4); intrinsic: (4, 4) or (V, 4, 4).

    Returns:
      pix (V, P, 2), in_front (V, P).
    """
    if intrinsic.ndim == 2:
        intrinsic = intrinsic.expand(w2c.shape)
    proj = feinsum("vij,vjk->vik", intrinsic, w2c)            # (V, 4, 4)
    homo = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    p = feinsum("vij,pj->vpi", proj, homo)                    # (V, P, 4)
    z = torch.clamp_min(p[..., 2:3], 1e-8)
    pix = torch.clamp(p[..., :2] / z, -1e6, 1e6)
    return pix, p[..., 2] > 0


def sample_views_at_points(points: torch.Tensor, images: torch.Tensor,
                           features: Optional[torch.Tensor],
                           w2c: torch.Tensor, intrinsic: torch.Tensor):
    """Sample every view's RGB (and features) at projected points
    (`Projector.compute`, projection.py:74-140): bilinear samples of the
    images at the image-resolution pixels and of the feature maps at those
    pixels divided by stride = H // h, with no half-pixel shift; the mask
    is in-bounds and in-front.

    Args:
      points: (P, 3); images: (V, H, W, 3) in [0, 1]; features: optional
        (V, h, w, C); w2c: (V, 4, 4); intrinsic: (4, 4) at image
        resolution.

    Returns:
      sampled (P, V, 3[+C]); mask (P, V) float.
    """
    v, h_img, w_img = images.shape[:3]
    pix, in_front = project_to_views(points, w2c, intrinsic)  # (V, P, 2)
    out = bilinear_sample(images, pix)
    if features is not None:
        stride = h_img // features.shape[1]
        out = torch.cat([out, bilinear_sample(features, pix / stride)],
                        dim=-1)
    inbound = ((pix[..., 0] >= 0) & (pix[..., 0] <= w_img - 1)
               & (pix[..., 1] >= 0) & (pix[..., 1] <= h_img - 1))
    mask = (inbound & in_front).to(out.dtype)                 # (V, P)
    return out.transpose(0, 1), mask.T


def masked_mean_var(feat: torch.Tensor, mask: torch.Tensor):
    """Masked mean and exp(-var) pooling over views
    (`compute_mask_points`, render_ray.py:52-58).

    Args:
      feat: (P, V, C); mask: (P, V).

    Returns:
      mean (P, C) and exp(-var) (P, C).
    """
    w = mask / (torch.sum(mask, dim=1, keepdim=True) + 1e-8)
    mean = torch.sum(feat * w[..., None], dim=1)
    var = torch.sum((feat - mean[:, None, :]) ** 2 * w[..., None], dim=1)
    return mean, torch.exp(-var)


def volume_sample_trilinear(volume: torch.Tensor, points: torch.Tensor,
                            aabb_min: Sequence[float],
                            aabb_max: Sequence[float]):
    """Trilinear sample of a voxel volume at world points with border
    padding (`volume_sampling`, render_ray.py:15-31, grid_sample
    align_corners=True, padding border), and the inside-aabb mask.

    Args:
      volume: (nx, ny, nz, C); points: (P, 3).

    Returns:
      (P, C) samples, (P,) bool inside mask.
    """
    dev = points.device
    aabb_min = torch.as_tensor(aabb_min, dtype=torch.float32, device=dev)
    aabb_max = torch.as_tensor(aabb_max, dtype=torch.float32, device=dev)
    nx, ny, nz, c = volume.shape
    norm = (points - aabb_min) / (aabb_max - aabb_min)        # 0..1
    inside = torch.all((norm > 0) & (norm < 1), dim=-1)
    sizes = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    # align_corners=True: 0 -> 0, 1 -> n-1
    idx = torch.clamp(norm, 0.0, 1.0) * (sizes - 1)
    hi = torch.tensor([nx - 2, ny - 2, nz - 2], device=dev)
    i0 = torch.minimum(torch.clamp_min(torch.floor(idx).long(), 0), hi)
    frac = idx - i0

    def corner(dx, dy, dz):
        w = ((frac[:, 0] if dx else 1 - frac[:, 0])
             * (frac[:, 1] if dy else 1 - frac[:, 1])
             * (frac[:, 2] if dz else 1 - frac[:, 2]))
        vals = volume[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
        return vals * w[:, None]

    out = sum(corner(dx, dy, dz)
              for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
    return out, inside
