# Frozen copy of mvsdet_torch/ops/splat.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Gaussian projection (port of mvsdet_tpu/ops/splat.py; the dense
renderer beside it in the program is not copied).

Perspective EWA splatting as the CUDA rasterizer the reference vendors
computes it: the clamped EWA Jacobian, a 0.3 px^2 low-pass and the conic
(inverse 2D covariance).
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.utils.precision import feinsum


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
