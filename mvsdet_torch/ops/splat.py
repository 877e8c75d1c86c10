"""Gaussian projection and the exact dense splat renderer (port of
mvsdet_tpu/ops/splat.py).

Perspective EWA splatting as the CUDA rasterizer the reference vendors
computes it: the clamped EWA Jacobian, a 0.3 px^2 low-pass, the conic
(inverse 2D covariance), the 0.99 alpha clamp and the 1/255 cutoff.

`render_view` is the exact renderer `MVSDet` takes with
`splat_impl != "tiled"`, and the oracle the tiled path is held against:
every Gaussian depth-sorted once per view (a stable sort, invalid ones
last), then composited front to back for each pixel through an exclusive
log-space cumulative transmittance, `pixel_chunk` pixels at a time.  It
is plain torch, differentiable by autograd, and costs memory: each
chunk's (P, G) intermediates take 4·P·G bytes apiece, and a backward
keeps every chunk's (README.md gives the sizes measured on the card).
It keeps every Gaussian's whole alpha footprint, where the tiled path
bins by a 3-sigma radius.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mvsdet_torch.geometry.sh import eval_sh_color
from mvsdet_torch.ops.splat_kernel import ALPHA_MAX, ALPHA_MIN
from mvsdet_torch.utils.precision import feinsum


def project_gaussians(means: torch.Tensor, covariances: torch.Tensor,
                      c2w: torch.Tensor, intrinsics_norm: torch.Tensor,
                      image_shape: Tuple[int, int], near_clip: float = 0.2):
    """Project world Gaussians into one camera.

    Args:
      means: (G, 3); covariances: (G, 3, 3); c2w: (4, 4);
      intrinsics_norm: (3, 3) normalised K; image_shape: (H, W).

    Returns:
      mean2d (G, 2) pixel centres, conic (G, 3) inverse-covariance upper
      triangle (a, b, c), z (G,) view depth, valid (G,) bool, cov_tri
      (G, 3) 2D covariance upper triangle.
    """
    h, w = image_shape
    w2c = torch.linalg.inv_ex(c2w).inverse
    rot = w2c[:3, :3]
    t = feinsum("ij,gj->gi", rot, means) + w2c[:3, 3]
    z = t[:, 2]
    valid = z > near_clip
    z_safe = torch.clamp_min(z, near_clip)

    fx = intrinsics_norm[0, 0] * w
    fy = intrinsics_norm[1, 1] * h
    cx = intrinsics_norm[0, 2] * w
    cy = intrinsics_norm[1, 2] * h
    mean2d = torch.stack([fx * t[:, 0] / z_safe + cx,
                          fy * t[:, 1] / z_safe + cy], dim=-1)

    # EWA Jacobian with the CUDA kernel's frustum clamp (1.3 * tan_fov)
    tan_x = 0.5 * w / fx
    tan_y = 0.5 * h / fy
    txz = torch.clamp(t[:, 0] / z_safe, -1.3 * tan_x, 1.3 * tan_x)
    tyz = torch.clamp(t[:, 1] / z_safe, -1.3 * tan_y, 1.3 * tan_y)
    zero = torch.zeros_like(z_safe)
    j = torch.stack([
        torch.stack([fx / z_safe, zero, -fx * txz / z_safe], -1),
        torch.stack([zero, fy / z_safe, -fy * tyz / z_safe], -1),
    ], dim=-2)                                                # (G, 2, 3)
    jw = feinsum("gij,jk->gik", j, rot)
    cov2d = feinsum("gij,gjk,glk->gil", jw, covariances, jw)
    cov2d = cov2d + 0.3 * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)

    a = cov2d[:, 0, 0]
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1]
    det = a * c - b * b
    det_safe = torch.where(det > 1e-12, det, 1.0)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    valid = valid & (det > 1e-12)
    cov_tri = torch.stack([a, b, c], dim=-1)
    return mean2d, conic, z, valid, cov_tri


def render_view(means: torch.Tensor, covariances: torch.Tensor,
                harmonics: torch.Tensor, opacities: torch.Tensor,
                c2w: torch.Tensor, intrinsics_norm: torch.Tensor,
                image_shape: Tuple[int, int],
                background: Optional[torch.Tensor] = None,
                pixel_chunk: int = 4096, near_clip: float = 0.2,
                value_override: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Render one target view from a Gaussian set, exactly.

    Args:
      means (G, 3), covariances (G, 3, 3), harmonics (G, 3, d_sh),
      opacities (G,): world Gaussians.
      c2w (4, 4), intrinsics_norm (3, 3): the target camera.
      image_shape: (H, W).
      background: (C,) colour behind the Gaussians (default zeros).
      pixel_chunk: pixels composited at a time (the memory bound).
      value_override: (G, C) values to composite instead of the SH colour
        (a camera depth, say).

    Returns:
      (H, W, C) float32, C = 3 or the override's width.
    """
    h, w = image_shape
    mean2d, conic, z, valid, _ = project_gaussians(
        means, covariances, c2w, intrinsics_norm, image_shape, near_clip)
    if value_override is None:
        dirs = means - c2w[:3, 3]
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
        values = eval_sh_color(harmonics, dirs)               # (G, 3)
    else:
        values = value_override
    n_ch = values.shape[-1]
    if background is None:
        background = torch.zeros(n_ch, dtype=values.dtype,
                                 device=values.device)

    # one front-to-back order; invalid Gaussians last, ties in Gaussian
    # order as jnp.argsort keeps them (trap T5)
    order = torch.argsort(torch.where(valid, z, torch.inf), stable=True)
    mean2d_s = mean2d[order]
    conic_s = conic[order]
    val_s = values[order]
    op_s = torch.where(valid, opacities, 0.0)[order]

    dev = means.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)  # (HW, 2)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    alpha_max = torch.full((), ALPHA_MAX, dtype=torch.float32, device=dev)

    def render_chunk(p):
        d = p[:, None, :] - mean2d_s[None, :, :]              # (P, G, 2)
        dx, dy = d[..., 0], d[..., 1]
        power = (-0.5 * (conic_s[None, :, 0] * dx * dx
                         + conic_s[None, :, 2] * dy * dy)
                 - conic_s[None, :, 1] * dx * dy)
        # torch.minimum splits a tie's gradient in half, as jnp.minimum does
        alpha = torch.minimum(
            op_s[None, :] * torch.exp(torch.minimum(power, zero)), alpha_max)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        # exclusive transmittance through a log-space cumulative sum
        log_t = torch.cumsum(torch.log1p(-alpha), dim=1)
        t_excl = torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]),
                                      log_t[:, :-1]], dim=1))
        out = feinsum("pg,gc->pc", t_excl * alpha, val_s)
        t_final = torch.exp(log_t[:, -1])
        return out + t_final[:, None] * background[None, :]

    out = torch.cat([render_chunk(p) for p in pix.split(pixel_chunk)])
    return out.reshape(h, w, n_ch)


def render_views(means, covariances, harmonics, opacities, c2ws,
                 intrinsics_norm, image_shape,
                 background: Optional[torch.Tensor] = None,
                 pixel_chunk: int = 4096) -> torch.Tensor:
    """Render several target views of one Gaussian set with `render_view`
    (`DecoderSplattingCUDA.forward`, decoder_splatting_cuda.py:37-71).

    Args:
      c2ws: (T, 4, 4); intrinsics_norm: (T, 3, 3).

    Returns:
      (T, H, W, 3).
    """
    return torch.stack([
        render_view(means, covariances, harmonics, opacities, c2w, k,
                    image_shape, background, pixel_chunk)
        for c2w, k in zip(c2ws, intrinsics_norm)])
