# Frozen copy of mvsdet_torch/geometry/cameras.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Camera math: projections, intrinsic scaling, neighbour-view selection.

Port of mvsdet_tpu/geometry/cameras.py (reference: mvsdet.py:43-104,
423-428, 1124-1156).  Conventions: ``w2c`` maps world -> camera;
``intrinsic`` is a 4x4 (or 3x3) pinhole K at the resolution it was
calibrated for.
"""

from __future__ import annotations

import torch

from benchmark.reference.utils.precision import feinsum


def scale_intrinsics(intrinsic: torch.Tensor, ratio: float) -> torch.Tensor:
    """Scale the first two rows of K by 1/ratio (``intrinsic[:2] /= ratio``).

    Args:
      intrinsic: (..., 3|4, 3|4) pinhole matrices.
      ratio: scalar.
    """
    scale = torch.ones(intrinsic.shape[-2], dtype=intrinsic.dtype,
                       device=intrinsic.device)
    scale[:2] = 1.0 / torch.tensor(ratio, dtype=intrinsic.dtype)
    return intrinsic * scale[:, None]


def full_projection(w2c: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """4x4 projection ``K @ w2c`` used by the plane sweep (mvsdet.py:259).

    Args:
      w2c: (N, 4, 4); intrinsic: (4, 4) or (N, 4, 4) at feature resolution.

    Returns:
      (N, 4, 4).
    """
    if intrinsic.ndim == 2:
        intrinsic = intrinsic.expand(w2c.shape)
    return feinsum("nij,njk->nik", intrinsic, w2c)


def top_k_indices(sim: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values of each row, the lower index
    first among equal values, as `jax.lax.top_k` orders them: a stable
    descending sort.  `torch.topk` promises no order among ties, and
    cameras tie in distance on a symmetric rig and whenever a scene with
    fewer frames than views repeats a view (ROADMAP F2)."""
    return torch.sort(sim, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def knn_camera_neighbors(positions: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest cameras (by centre distance) per camera.

    Negative squared distance, self masked by -1e5, top-k by similarity
    (`get_nearest_pose_ids(..., 'dist', maskself=True)`, mvsdet.py:43-93).

    Returns:
      (N, k) int64 neighbour indices.
    """
    sq = torch.sum(positions**2, dim=-1)
    sim = 2.0 * positions @ positions.T - sq[:, None] - sq[None, :]
    n = positions.shape[0]
    sim = sim - torch.eye(n, dtype=sim.dtype, device=sim.device) * 1e5
    return top_k_indices(sim, k)


def nearest_pose_ids(tar_c2w: torch.Tensor, ref_c2w: torch.Tensor,
                     num_select: int) -> torch.Tensor:
    """For each target pose, the nearest reference poses by camera centre
    (`get_nearest_pose_ids` with 'dist', mvsdet.py:67-104).

    Args:
      tar_c2w: (T, 4, 4); ref_c2w: (N, 4, 4); num_select: k.

    Returns:
      (T, num_select) int64 indices into the reference set.
    """
    tar = tar_c2w[:, :3, 3]
    ref = ref_c2w[:, :3, 3]
    sq_t = torch.sum(tar**2, dim=-1)
    sq_r = torch.sum(ref**2, dim=-1)
    sim = 2.0 * tar @ ref.T - sq_t[:, None] - sq_r[None, :]
    return top_k_indices(sim, num_select)
