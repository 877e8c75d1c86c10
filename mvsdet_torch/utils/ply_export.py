"""Gaussian point-cloud export to the standard 3DGS .ply layout.

Equivalent of the reference's `export_ply`
(gs_src/model/ply_export.py:28-96): writes a binary-little-endian PLY
with the attribute list [x y z nx ny nz f_dc_0..2 opacity scale_0..2
rot_0..3] that 3DGS viewers (Polycam, supersplat) read.  Written with
plain struct/numpy — no plyfile dependency.

Differences from the reference, both deliberate:
  * no Polycam-specific 45-degree/up-vector re-orientation — gaussians
    are exported in world space (optionally rotated into a given camera
    frame), which round-trips;
  * our adapter outputs covariances, so scales/rotations are recovered
    by eigendecomposition (cov = R diag(s^2) R^T).

A copy of mvsdet_tpu/utils/ply_export.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rotmat_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """Batch rotation matrices (G, 3, 3) -> quaternions (G, 4) wxyz."""
    g = r.shape[0]
    q = np.zeros((g, 4), np.float64)
    tr = np.trace(r, axis1=1, axis2=2)
    # four numerically-stable branches, picked per element
    m = [[r[:, i, j] for j in range(3)] for i in range(3)]
    cand = np.stack([
        1.0 + tr,
        1.0 + m[0][0] - m[1][1] - m[2][2],
        1.0 - m[0][0] + m[1][1] - m[2][2],
        1.0 - m[0][0] - m[1][1] + m[2][2],
    ], axis=1)
    best = np.argmax(cand, axis=1)
    s = 2.0 * np.sqrt(np.maximum(cand[np.arange(g), best], 1e-12))
    w_, x_, y_, z_ = (m[2][1] - m[1][2], m[0][2] - m[2][0],
                      m[1][0] - m[0][1], None)
    for b in range(4):
        sel = best == b
        if not np.any(sel):
            continue
        ss = s[sel]
        if b == 0:
            q[sel] = np.stack([ss / 4, w_[sel] / ss, x_[sel] / ss,
                               y_[sel] / ss], 1)
        elif b == 1:
            q[sel] = np.stack([w_[sel] / ss, ss / 4,
                               (m[0][1] + m[1][0])[sel] / ss,
                               (m[0][2] + m[2][0])[sel] / ss], 1)
        elif b == 2:
            q[sel] = np.stack([x_[sel] / ss,
                               (m[0][1] + m[1][0])[sel] / ss, ss / 4,
                               (m[1][2] + m[2][1])[sel] / ss], 1)
        else:
            q[sel] = np.stack([y_[sel] / ss,
                               (m[0][2] + m[2][0])[sel] / ss,
                               (m[1][2] + m[2][1])[sel] / ss, ss / 4], 1)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def covariance_to_scale_rot(cov: np.ndarray):
    """(G, 3, 3) covariances -> (scales (G,3), quats wxyz (G,4)).

    cov = R diag(s^2) R^T; eigh returns ascending eigenvalues with an
    orthonormal basis whose determinant is forced to +1.
    """
    cov = 0.5 * (cov + np.swapaxes(cov, 1, 2))
    vals, vecs = np.linalg.eigh(cov.astype(np.float64))
    scales = np.sqrt(np.maximum(vals, 1e-18)).astype(np.float32)
    det = np.linalg.det(vecs)
    vecs[det < 0, :, 2] *= -1.0
    return scales, _rotmat_to_quat_wxyz(vecs)


def export_ply(path: str, means: np.ndarray, covariances: np.ndarray,
               harmonics: np.ndarray, opacities: np.ndarray,
               min_opacity: float = 0.0,
               extrinsics: Optional[np.ndarray] = None) -> int:
    """Write gaussians as a 3DGS-format binary PLY.  Returns the count.

    Args:
      means: (G, 3); covariances: (G, 3, 3); harmonics: (G, 3, d_sh)
        (only the DC band is exported, like the reference :79-81);
      opacities: (G,); min_opacity: drop gaussians below this;
      extrinsics: optional (4, 4) c2w — export in that camera frame.
    """
    means = np.asarray(means, np.float32)
    cov = np.asarray(covariances, np.float32)
    sh = np.asarray(harmonics, np.float32)
    op = np.asarray(opacities, np.float32).reshape(-1)
    keep = op > min_opacity
    means, cov, sh, op = means[keep], cov[keep], sh[keep], op[keep]
    g = means.shape[0]

    if extrinsics is not None and g:
        w2c = np.linalg.inv(np.asarray(extrinsics, np.float64))
        means = (means @ w2c[:3, :3].T + w2c[:3, 3]).astype(np.float32)
        cov = np.einsum("ij,gjk,lk->gil", w2c[:3, :3], cov,
                        w2c[:3, :3]).astype(np.float32)

    scales, quats = (covariance_to_scale_rot(cov) if g else
                     (np.zeros((0, 3), np.float32),
                      np.zeros((0, 4), np.float32)))
    eps = np.float32(1e-10)
    rows = np.concatenate([
        means,
        np.zeros_like(means),                      # nx ny nz
        sh[..., 0],                                # f_dc (DC band only)
        # inverse-sigmoid: 3DGS viewers apply sigmoid to the stored value
        np.log(np.clip(op, eps, 1 - 1e-6)
               / np.clip(1 - op, eps, None))[:, None],
        np.log(np.maximum(scales, eps)),           # stored as log-scale
        quats,
    ], axis=1).astype("<f4")

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {g}"]
    header += [f"property float {n}" for n in names]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rows.tobytes())
    return g
