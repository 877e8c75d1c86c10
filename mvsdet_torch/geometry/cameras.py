"""Camera math: projections, intrinsic scaling, neighbour-view selection.

Port of mvsdet_tpu/geometry/cameras.py (reference: mvsdet.py:43-104,
423-428, 1124-1156).  Conventions: ``w2c`` maps world -> camera;
``intrinsic`` is a 4x4 (or 3x3) pinhole K at the resolution it was
calibrated for.
"""

from __future__ import annotations

import torch

from mvsdet_torch.utils.precision import feinsum


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


def compute_projection(w2c: torch.Tensor, intrinsic: torch.Tensor,
                       ratio: float) -> torch.Tensor:
    """Per-view world->image projection K[R|t] at feature resolution
    (`MVSDet._compute_projection`, mvsdet.py:1124-1156):
    ``P_i = (K / ratio)[:3, :3] @ E_i[:3]``.

    Args:
      w2c: (N, 4, 4); intrinsic: (4, 4) shared K or (N, 4, 4) per view;
      ratio: original-resolution-to-feature-resolution scale factor.

    Returns:
      (N, 3, 4).
    """
    k = scale_intrinsics(intrinsic, ratio)
    if k.ndim == 2:
        k = k.expand((w2c.shape[0],) + k.shape)
    return feinsum("nij,njk->nik", k[:, :3, :3], w2c[:, :3, :4])


def world_to_image(points: torch.Tensor, projection: torch.Tensor):
    """Project world points through one (3, 4) projection.

    A depth within 1e-8 of 0 divides by sign(z) * 1e-8 + 1e-12 instead, as
    the JAX function guards it (so z = 0 exactly divides by 1e-12).

    Args:
      points: (..., 3); projection: (3, 4).

    Returns:
      (xy, z): (..., 2) pixel coordinates and (...,) camera-space depth.
    """
    homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    p = feinsum("ij,...j->...i", projection, homo)
    z = p[..., 2:3]
    xy = p[..., :2] / torch.where(z.abs() < 1e-8,
                                  torch.sign(z) * 1e-8 + 1e-12, z)
    return xy, p[..., 2]


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
