# Frozen copy of mvsdet_torch/ops/voxel_lift.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.  The feature gather is the plain
# `weighted_gather_sum_reference` of mvsdet_torch/ops/lift_kernel.py at
# the same commit, with its plain d-feat and d-weight.
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
plain PyTorch over all views at once, and so is the (V, C) feature
gather, `weighted_gather_sum`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.utils.precision import feinsum


class _WeightedGatherSum(torch.autograd.Function):
    """The gather and weighted sum, with its gradients written out: the
    features' in one piece, as the program's backward hands it over, so
    that autograd meets the sweep's and the splats' gradients of the same
    features in the program's order and adds them alike."""

    @staticmethod
    def forward(ctx, feat, pix, weight):
        ctx.save_for_backward(feat, pix, weight)
        out = torch.zeros((pix.shape[1], feat.shape[2]), dtype=torch.float32,
                          device=feat.device)
        for i in range(feat.shape[0]):
            out = out + feat[i].index_select(0, pix[i].long()) \
                * weight[i, :, None]
        return out

    @staticmethod
    def backward(ctx, g):
        feat, pix, weight = ctx.saved_tensors
        dfeat = torch.zeros_like(feat)
        for i in range(feat.shape[0]):
            dfeat[i].index_add_(0, pix[i].long(), g * weight[i, :, None])
        dweight = torch.stack([(feat[i].index_select(0, pix[i].long()) * g)
                               .sum(-1) for i in range(feat.shape[0])])
        return dfeat, None, dweight


def weighted_gather_sum(feat: torch.Tensor, pix: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """sum_n weight[n, v] * feat[n, pix[n, v], :] -> (V, C), views added in
    order n = 0..N-1 as the XLA scan does (mvsdet_tpu/ops/voxel_lift.py:
    136-151)."""
    return _WeightedGatherSum.apply(feat, pix, weight)


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
      features: (N, H, W, C).
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
