# Frozen copy of mvsdet_torch/geometry/sh.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Real spherical harmonics: evaluation and rotation (port of
mvsdet_tpu/geometry/sh.py).

Evaluation uses the 3DGS basis and constants.  Rotation is the
sampling-based projection of the JAX package: for a rotation R the
per-degree block is ``D = pinv(B(S)) @ B(R^T S)`` over a fixed direction
sample set S, so ``eval(rotate_sh(c, R), d) == eval(c, R^T d)``.  The
numpy pseudo-inverse blocks are copied here (`_pinv_blocks`), computed in
float64 on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.utils.precision import feinsum, fmatmul

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

MAX_DEGREE = 4


def eval_sh_basis(dirs, degree: int):
    """Real SH basis at unit directions, (..., (degree+1)**2), degree-major,
    m = -l..l.  numpy in -> numpy out (for the host-side pinv blocks),
    torch in -> torch out."""
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} unsupported (max {MAX_DEGREE})")
    stack = np.stack if isinstance(dirs, np.ndarray) else torch.stack
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [_C0 * (x * 0 + 1)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3.0 * xx - yy),
            _C4[2] * xy * (7.0 * zz - 1.0),
            _C4[3] * yz * (7.0 * zz - 3.0),
            _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _C4[5] * xz * (7.0 * zz - 3.0),
            _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _C4[7] * xz * (xx - 3.0 * yy),
            _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return stack(out, -1)


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    )


_N_SAMPLES = 64
_SAMPLES = _fibonacci_sphere(_N_SAMPLES)


def _pinv_blocks(degree: int) -> List[np.ndarray]:
    """pinv of the per-degree basis blocks at the fixed sample directions."""
    b = np.asarray(eval_sh_basis(_SAMPLES, degree), np.float64)
    return [np.linalg.pinv(b[:, l * l:(l + 1) * (l + 1)])
            for l in range(degree + 1)]


_PINV_CACHE: Dict[int, List[np.ndarray]] = {}


def _get_pinv_blocks(degree: int) -> List[np.ndarray]:
    if degree not in _PINV_CACHE:
        _PINV_CACHE[degree] = _pinv_blocks(degree)
    return _PINV_CACHE[degree]


def sh_rotation_matrix(rot: torch.Tensor, degree: int) -> torch.Tensor:
    """Block-diagonal (..., n, n) rotation of real SH coefficients,
    n = (degree+1)**2, with ``eval(D @ c, d) == eval(c, R^T d)``."""
    n = (degree + 1) ** 2
    samples = torch.as_tensor(_SAMPLES, dtype=rot.dtype, device=rot.device)
    rotated = feinsum("...ji,sj->...si", rot, samples)        # R^T s
    basis_rot = eval_sh_basis(rotated, degree)                # (..., S, n)
    out = torch.zeros(rot.shape[:-2] + (n, n), dtype=rot.dtype,
                      device=rot.device)
    for l, pinv in enumerate(_get_pinv_blocks(degree)):
        pinv_t = torch.as_tensor(pinv, dtype=rot.dtype, device=rot.device)
        out[..., l * l:(l + 1) ** 2, l * l:(l + 1) ** 2] = feinsum(
            "ms,...sk->...mk", pinv_t, basis_rot[..., l * l:(l + 1) ** 2])
    return out


def rotate_sh(sh: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate (..., n) SH coefficient vectors by broadcastable (..., 3, 3)
    rotations."""
    n = sh.shape[-1]
    degree = int(round(n**0.5)) - 1
    if (degree + 1) ** 2 != n:
        raise ValueError(f"sh dim {n} is not a square")
    d = sh_rotation_matrix(rot, degree)
    return fmatmul(d, sh[..., None])[..., 0]


def eval_sh_color(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Non-negative RGB from (..., 3, n) SH coefficients and (..., 3) unit
    view directions: basis . coefficients + 0.5, clamped at 0."""
    n = sh.shape[-1]
    degree = int(round(n**0.5)) - 1
    basis = eval_sh_basis(dirs, degree)
    color = feinsum("...cn,...n->...c", sh, basis) + 0.5
    return torch.clamp_min(color, 0.0)
