"""Full-precision contraction helpers (counterpart of
mvsdet_tpu/utils/precision.py).

Geometry math — projections, homographies, ray transforms — needs true
fp32: a TF32 pixel coordinate at x~300 carries ~0.1 px error.  On CUDA,
fp32 matmuls may run in TF32 when `torch.backends.cuda.matmul.allow_tf32`
is set, so every geometry contraction goes through `feinsum`, which turns
TF32 off for the call whatever the global setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Run the enclosed CUDA matmuls and convolutions in full fp32."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def feinsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` in full fp32 (the JAX package's Precision.HIGHEST)."""
    with no_tf32():
        return torch.einsum(equation, *operands)


def fmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting `a @ b` in full fp32."""
    with no_tf32():
        return torch.matmul(a, b)
