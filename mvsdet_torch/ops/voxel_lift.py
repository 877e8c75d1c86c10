"""Depth-weighted 2D->3D voxel feature lifting.

Port of mvsdet_tpu/ops/voxel_lift.py (reference: `backproject_Weigh`,
mvsdet.py:1372-1492).  Per view i and voxel v (centre p_v):

  (x, y, z) = round(K[R|t]_i p_v)                       nearest pixel
  valid0    = in bounds and z > 0
  window_k  = valid0 and |z - d_k(y, x)| < voxel_size_z
  valid     = any_k window_k
  w         = max_k window_k * prob_norm_k(y, x)
  vol[v]   += w * feat_i(y, x)

The per-view projection, window and weight math (`_pixel_weights`) is
plain PyTorch over all views at once; the (V, C) feature gather goes
through `weighted_gather_sum`, the CUDA kernel on the card.  The lift
returns float32, the accumulator's type (ROADMAP trap T6), for float32
and bf16 features alike, and d-feat in the features' dtype.
`lift_diagnostics` grades the same weights against GT depth (the
predict's diagnostics).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvsdet_torch.ops.lift_kernel import weighted_gather_sum
from mvsdet_torch.utils.precision import feinsum


def _pixel_weights(projections: torch.Tensor, est_depth: torch.Tensor,
                   prob_norm: torch.Tensor, points: torch.Tensor,
                   voxel_size_z: float):
    """Every view's (pix, weight, valid) per voxel.

    Args:
      projections: (N, 3, 4); est_depth, prob_norm: (N, H, W, K);
      points: (V, 3).

    Returns:
      pix: (N, V) int32 flat clipped pixel index.
      weight: (N, V) max in-window hypothesis probability (0 if invalid).
      valid: (N, V) bool.
    """
    pix, weight, valid, _, _ = _window_weights(
        projections, est_depth, prob_norm, points, voxel_size_z)
    return pix, weight, valid


def _window_weights(projections, est_depth, prob_norm, points, voxel_size_z):
    """`_pixel_weights`, and each voxel's camera z and in-frustum bit."""
    n, h, w, k = est_depth.shape
    homo = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    p = feinsum("nij,vj->nvi", projections, homo)             # (N, V, 3)
    z = p[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
    x = torch.round(p[..., 0] / z_safe).to(torch.int32)
    y = torch.round(p[..., 1] / z_safe).to(torch.int32)
    valid0 = (x >= 0) & (y >= 0) & (x < w) & (y < h) & (z > 0)
    pix = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)           # (N, V) int32

    dp = torch.cat([est_depth.reshape(n, h * w, k),
                    prob_norm.reshape(n, h * w, k)], dim=2)   # (N, HW, 2K)
    rows = torch.gather(dp, 1, pix.long()[..., None].expand(-1, -1, 2 * k))
    d_k, p_k = rows[..., :k], rows[..., k:]
    zz = z[..., None]
    window = valid0[..., None] & (zz > d_k - voxel_size_z) \
        & (zz < d_k + voxel_size_z)                           # (N, V, K)
    valid = window.any(dim=2)
    weight = torch.where(window, p_k, 0.0).amax(dim=2)
    return pix, weight, valid, z, valid0


def lift_features_to_voxels(features: torch.Tensor, projections: torch.Tensor,
                            est_depth: torch.Tensor, est_prob: torch.Tensor,
                            points: torch.Tensor, voxel_size_z: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate depth-weighted per-view features into the voxel grid.

    Args:
      features: (N, H, W, C) f32, or bf16 in a model computing in bf16
        (the rows widened exactly, the weights and sums float32).
      projections: (N, 3, 4).
      est_depth, est_prob: (N, H, W, K) top-k z-depths and probabilities
        (normalised over K here, mvsdet.py:1395-1396).
      points: (V, 3) voxel centres.
      voxel_size_z: z window half-width.

    Returns:
      volume_sum: (V, C) f32 sum of weighted contributions over views.
      valid_count: (V,) f32 number of views whose window holds the voxel.
    """
    n, h, w, c = features.shape
    prob_norm = est_prob / (est_prob.sum(dim=-1, keepdim=True) + 1e-12)
    pix, weight, valid = _pixel_weights(projections, est_depth, prob_norm,
                                        points, voxel_size_z)
    vol = weighted_gather_sum(features.reshape(n, h * w, c), pix, weight)
    return vol, valid.to(torch.float32).sum(dim=0)


def finalize_volume(volume_sum: torch.Tensor,
                    valid_count: torch.Tensor) -> torch.Tensor:
    """View-mean with empty voxels zeroed (mvsdet.py:511-515, 681-682)."""
    mean = volume_sum / (valid_count[:, None] + 1e-8)
    return torch.where(valid_count[:, None] > 0, mean, 0.0)


def lift_diagnostics(projections: torch.Tensor, est_depth: torch.Tensor,
                     est_prob: torch.Tensor, points: torch.Tensor,
                     voxel_size_z: float, gt_depth: torch.Tensor,
                     depth_expect: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT-depth-assisted lift diagnostics (mvsdet_tpu/ops/voxel_lift.py:
    198-258; the reference's debug branch, mvsdet.py:1436-1492).

    Per view, every in-frustum voxel gets a GT-validity bit: its camera z
    lies within one ``voxel_size_z`` of the GT depth at its pixel.  The
    view's gap is the in-frustum mean of (bit - lifted weight)^2, and
    `weight_gap` the mean over views.  `src_rmse` is the masked MSE of
    ``depth_expect`` against GT over pixels with GT > 0 (an MSE despite
    the name, as the reference computes it, :1446-1448).

    Args:
      projections: (N, 3, 4); est_depth, est_prob: (N, H, W, K);
      points: (V, 3); gt_depth: (N, H, W) at feature resolution (0 =
      invalid); depth_expect: (N, H, W).

    Returns:
      (weight_gap, src_rmse), float32 scalars.
    """
    n, h, w = gt_depth.shape
    prob_norm = est_prob / (est_prob.sum(dim=-1, keepdim=True) + 1e-12)
    pix, weight, _, z, valid0 = _window_weights(
        projections, est_depth, prob_norm, points, voxel_size_z)
    gt_z = torch.gather(gt_depth.reshape(n, h * w), 1, pix.long())
    gt_valid = (valid0 & (z > gt_z - voxel_size_z)
                & (z < gt_z + voxel_size_z)).to(torch.float32)
    gaps = (torch.where(valid0, (gt_valid - weight) ** 2, 0.0).sum(dim=1)
            / valid0.sum(dim=1).clamp_min(1))
    mask = gt_depth > 0
    src_rmse = (torch.where(mask, (depth_expect - gt_depth) ** 2, 0.0).sum()
                / mask.sum().clamp_min(1))
    return gaps.mean(), src_rmse
