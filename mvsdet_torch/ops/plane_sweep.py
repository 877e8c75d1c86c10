"""Plane-sweep cost volume: homography warp + variance aggregation.

Port of the gather path of mvsdet_tpu/ops/plane_sweep.py (reference:
mvsdet.py:438-467, mvs_models/module.py:105-146).  The JAX package's fast
TPU path, the shear-matmul warp of `plane_sweep_mxu.py`, is a TPU
discretisation and is not ported; this bilinear gather is the JAX
package's own oracle.  Layout is channels-last (M, D, H, W, C) at the
public function, as in the JAX package.
"""

from __future__ import annotations

import torch

from mvsdet_torch.ops.sampling import bilinear_sample
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
