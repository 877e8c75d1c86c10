# Frozen copy of mvsdet_torch/geometry/rays.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Ray and image-grid math (port of mvsdet_tpu/geometry/rays.py;
reference: gs_src/geometry/projection.py:74-138, mvsdet.py:1158-1187)."""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.utils.precision import feinsum


def sample_image_grid(shape: Tuple[int, int], device=None):
    """Normalised (0,1) pixel-centre coordinates and integer indices.

    Returns:
      xy: (H, W, 2) fp32 coordinates, (x, y) order, centres at (i+0.5)/len.
      ij: (H, W, 2) int64 indices, (row, col) order.
    """
    h, w = shape
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    ij = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), dim=-1)
    ys = (rows.to(torch.float32) + 0.5) / h
    xs = (cols.to(torch.float32) + 0.5) / w
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xg, yg], dim=-1), ij


def unproject(coords: torch.Tensor, z: torch.Tensor,
              intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject 2D coordinates at depth z through inv(K)."""
    homo = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)
    dirs = feinsum("...ij,...j->...i",
                   torch.linalg.inv_ex(intrinsics).inverse, homo)
    return dirs * z[..., None]


def get_world_rays(coords: torch.Tensor, c2w: torch.Tensor,
                   intrinsics: torch.Tensor):
    """World-space ray origins and unit directions for image coordinates.

    Args:
      coords: (..., 2) in the intrinsics' units; c2w: (..., 4, 4);
      intrinsics: (..., 3, 3), all broadcast together.

    Returns:
      (origins, directions), both (..., 3).
    """
    d_cam = unproject(coords, torch.ones(coords.shape[:-1], dtype=coords.dtype,
                                         device=coords.device), intrinsics)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    d_world = feinsum("...ij,...j->...i", c2w[..., :3, :3], d_cam)
    origins = c2w[..., :3, 3].expand(d_world.shape)
    return origins, d_world


def depth_scale_map(height: int, width: int,
                    feat_intrinsic: torch.Tensor) -> torch.Tensor:
    """Per-pixel z-depth -> ray-depth factor (`compute_depth_scale`,
    mvsdet.py:1158-1187): the z of the unit camera ray through each
    integer pixel coordinate.

    Args:
      feat_intrinsic: (3, 3) or (4, 4) K at feature resolution, or
        (N, 3|4, 3|4) per view (ARKit, `compute_depth_scale_MultiIntrin`,
        mvsdet.py:1189-1218).

    Returns:
      (H*W, 1) for one K, (N, H*W, 1) for per-view Ks.
    """
    k = feat_intrinsic[..., :3, :3]
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=k.dtype, device=k.device),
        torch.arange(width, dtype=k.dtype, device=k.device), indexing="ij")
    uv = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    if k.ndim == 3:
        uv = uv.expand((k.shape[0],) + uv.shape)
        k = k[:, None]                      # one K for each view's pixels
    d = unproject(uv, torch.ones(uv.shape[:-1], dtype=k.dtype,
                                 device=k.device), k)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return d[..., 2:3]
