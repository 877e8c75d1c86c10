# Frozen copy of mvsdet_torch/geometry/transforms.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Rotation / covariance helpers for Gaussian primitives (port of
mvsdet_tpu/geometry/transforms.py; reference:
gs_src/model/encoder/common/gaussians.py:8-44)."""

from __future__ import annotations

import torch

from benchmark.reference.utils.precision import feinsum


def quaternion_to_matrix(q_xyzw: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """(..., 3, 3) rotation from an (x, y, z, w) quaternion, normalised by
    2/(|q|^2 + eps)."""
    i, j, k, r = torch.unbind(q_xyzw, dim=-1)
    two_s = 2.0 / (torch.sum(q_xyzw * q_xyzw, dim=-1) + eps)
    o = torch.stack([
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(o.shape[:-1] + (3, 3))


def build_covariance(scale: torch.Tensor,
                     rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) covariance R diag(s^2) R^T from scales and a quaternion."""
    rot = quaternion_to_matrix(rotation_xyzw)
    return feinsum("...ik,...k,...jk->...ij", rot, scale**2, rot)
