# Frozen copy of mvsdet_torch/utils/precision.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
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
import functools

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
    """`torch.einsum` in full fp32 (the JAX package's Precision.HIGHEST),
    the operands first promoted to one dtype as `jnp.einsum` promotes them
    (a bf16 rotation with float32 scales gives float32; `torch.einsum`
    would raise)."""
    dtype = functools.reduce(torch.promote_types,
                             (o.dtype for o in operands))
    with no_tf32():
        return torch.einsum(equation, *(o.to(dtype) for o in operands))


def fmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting `a @ b` in full fp32."""
    with no_tf32():
        return torch.matmul(a, b)
