"""Plane-sweep cost volume: homography warp + variance aggregation.

Port of the gather path of mvsdet_tpu/ops/plane_sweep.py (reference:
mvsdet.py:438-467, mvs_models/module.py:105-146): the bilinear gather,
`MVSDet(sweep_method="gather")`.  The default sweep, the two-product
shear warp, is `plane_sweep_mxu.py`.  Layout is channels-last
(M, D, H, W, C) at the public function, as in the JAX package.  `MVSDet` sweeps a chunk of
reference views at a time (`plane_sweep_variance_for_refs`);
`plane_sweep_variance` sweeps every view and `homography_warp` warps one
(ref, source) pair.
"""

from __future__ import annotations

import torch

from mvsdet_torch.ops.sampling import bilinear_sample, torch_grid_sample_skew
from mvsdet_torch.utils.precision import feinsum


def homography_coords(rel_proj: torch.Tensor, depth_values: torch.Tensor,
                      height: int, width: int) -> torch.Tensor:
    """Source-view pixel coordinates for every (depth, ref-pixel).

    p = R @ (x, y, 1) * d + t, xy = p[:2] / p[2] (module.py:115-140).

    Args:
      rel_proj: (..., 4, 4) relative projections src_proj @ inv(ref_proj).
      depth_values: (D,) plane depths.

    Returns:
      (..., D, H, W, 2) source pixel coordinates (x, y).
    """
    dev = rel_proj.device
    rot = rel_proj[..., :3, :3]
    trans = rel_proj[..., :3, 3]
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    xyz = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    rot_xyz = feinsum("...ij,hwj->...hwi", rot, xyz)          # (..., H, W, 3)
    proj = (rot_xyz[..., None, :, :, :] * depth_values[:, None, None, None]
            + trans[..., None, None, None, :])                # (..., D, H, W, 3)
    z = proj[..., 2:3]
    # guard only an exact zero (the huge coordinates then sample zeros)
    z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
    return proj[..., :2] / z_safe


def homography_warp(src_feat: torch.Tensor, rel_proj: torch.Tensor,
                    depth_values: torch.Tensor,
                    torch_compat: bool = False) -> torch.Tensor:
    """Warp one source feature map onto the ref view's depth planes
    (`homo_warping`, module.py:105-146, for one pair).

    Args:
      src_feat: (H, W, C) source-view features.
      rel_proj: (4, 4) src_proj @ inv(ref_proj).
      depth_values: (D,).
      torch_compat: sample where the reference's `grid_sample` taps
        (`torch_grid_sample_skew`); default the intended coordinates.

    Returns:
      (D, H, W, C), zeros outside the source image.
    """
    h, w, _ = src_feat.shape
    coords = homography_coords(rel_proj, depth_values, h, w)
    if torch_compat:
        coords = torch_grid_sample_skew(coords, h, w)
    return bilinear_sample(src_feat[None], coords[None])[0]


def plane_sweep_variance(features: torch.Tensor, proj: torch.Tensor,
                         neighbor_ids: torch.Tensor,
                         depth_values: torch.Tensor) -> torch.Tensor:
    """Variance volumes over {ref, k neighbours} for every view
    (mvsdet.py:438-467): `plane_sweep_variance_for_refs` with every view
    its own reference.

    Args:
      features: (N, H, W, C); proj: (N, 4, 4) full projections at feature
      resolution; neighbor_ids: (N, k); depth_values: (D,).

    Returns:
      (N, D, H, W, C).
    """
    ref_ids = torch.arange(features.shape[0], device=features.device)
    return plane_sweep_variance_for_refs(features, proj, ref_ids,
                                         neighbor_ids, depth_values)


def plane_sweep_variance_for_refs(features: torch.Tensor, proj: torch.Tensor,
                                  ref_ids: torch.Tensor,
                                  neighbor_ids: torch.Tensor,
                                  depth_values: torch.Tensor) -> torch.Tensor:
    """Variance volumes over {ref, k neighbours} for a chunk of ref views.

    volume_variance = E[f^2] - E[f]^2 over the (k+1) member volumes, member
    0 the ref feature broadcast over depth (mvsdet.py:438-467).

    Args:
      features: (N, H, W, C) all views' feature maps (the neighbour pool).
      proj: (N, 4, 4) full projections at feature resolution.
      ref_ids: (M,) reference views of this chunk.
      neighbor_ids: (M, k) neighbour indices into the full view set.
      depth_values: (D,).

    Returns:
      (M, D, H, W, C) variance volumes.
    """
    m, k = neighbor_ids.shape
    _, h, w, c = features.shape
    inv_ref = torch.linalg.inv_ex(proj[ref_ids]).inverse     # (M, 4, 4)
    rel = feinsum("mkij,mjl->mkil", proj[neighbor_ids], inv_ref)
    coords = homography_coords(rel.reshape(m * k, 4, 4), depth_values, h, w)
    nei_feat = features[neighbor_ids.reshape(-1)]             # (M*k, H, W, C)
    warped = bilinear_sample(nei_feat, coords)                # (M*k, D, H, W, C)
    warped = warped.reshape((m, k) + warped.shape[1:])

    ref = features[ref_ids][:, None]                          # (M, 1, H, W, C)
    s = ref + warped.sum(dim=1)
    sq = ref**2 + (warped**2).sum(dim=1)
    inv_m = 1.0 / (k + 1)
    mean = s * inv_m
    return sq * inv_m - mean**2
