"""Voxel-lift weighted gather: CUDA kernels and plain versions.

Port of mvsdet_tpu/ops/pallas/lift_kernel.py.  `weighted_gather_sum`
launches the hand-written kernel `csrc/weighted_gather_sum.cu` on CUDA
tensors and runs `weighted_gather_sum_reference` on CPU tensors.  When
feat or weight requires grad it goes through `_WeightedGatherSum`, whose
backward is `weighted_gather_sum_dfeat` and `weighted_gather_sum_dweight`
(the two kernels of `csrc/weighted_gather_sum_bwd.cu` on CUDA tensors,
their plain versions on CPU tensors).  pix takes no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from mvsdet_torch.ops import build


def weighted_gather_sum_reference(feat: torch.Tensor, pix: torch.Tensor,
                                  weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather and weighted sum, views added in order n = 0..N-1
    as the XLA scan does (mvsdet_tpu/ops/voxel_lift.py:136-151)."""
    out = torch.zeros((pix.shape[1], feat.shape[2]), dtype=torch.float32,
                      device=feat.device)
    for i in range(feat.shape[0]):
        rows = feat[i].index_select(0, pix[i].long()).to(torch.float32)
        out = out + rows * weight[i, :, None]
    return out


def weighted_gather_sum_dfeat_reference(pix: torch.Tensor,
                                        weight: torch.Tensor,
                                        g: torch.Tensor,
                                        hw: int) -> torch.Tensor:
    """Plain d-feat: dfeat[n, p] = sum_v [pix[n, v] = p] weight[n, v] g[v],
    one `index_add_` per view.  Returns (N, HW, C)."""
    n = pix.shape[0]
    dfeat = torch.zeros((n, hw, g.shape[1]), dtype=torch.float32,
                        device=g.device)
    for i in range(n):
        dfeat[i].index_add_(0, pix[i].long(), g * weight[i, :, None])
    return dfeat


def weighted_gather_sum_dweight_reference(feat: torch.Tensor,
                                          pix: torch.Tensor,
                                          g: torch.Tensor) -> torch.Tensor:
    """Plain d-weight: dw[n, v] = <feat[n, pix[n, v]], g[v]>, (N, V)."""
    return torch.stack([(feat[i].index_select(0, pix[i].long()) * g).sum(-1)
                        for i in range(feat.shape[0])])


def _check_pix(pix: torch.Tensor, n: int, device, weight=None):
    if pix.ndim != 2 or pix.shape[0] != n or (
            weight is not None and weight.shape != pix.shape):
        raise ValueError(f"pix and weight must both be (N={n}, V), got "
                         f"{tuple(pix.shape)} and "
                         f"{None if weight is None else tuple(weight.shape)}")
    if pix.dtype != torch.int32:
        raise TypeError(f"pix must be int32, got {pix.dtype}")
    if weight is not None and weight.dtype != torch.float32:
        raise TypeError("weighted_gather_sum takes float32 weights")
    if pix.device != device or (weight is not None
                                and weight.device != device):
        raise ValueError("feat, pix, weight and g must be on one device")


def _check_rows(x: torch.Tensor, what: str):
    """x holds float32 rows of C channels, C % 4 == 0 on the card."""
    if x.dtype != torch.float32:
        raise TypeError(f"weighted_gather_sum takes float32 {what}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"weighted_gather_sum runs on cpu or cuda, "
                         f"not {x.device}")
    if x.device.type == "cuda" and x.shape[-1] % 4:
        raise ValueError(f"the CUDA gather loads float4 rows: "
                         f"C={x.shape[-1]} must be a multiple of 4")


def _check(feat, pix, weight):
    if feat.ndim != 3:
        raise ValueError(f"feat must be (N, HW, C), got {tuple(feat.shape)}")
    _check_rows(feat, "feat")
    _check_pix(pix, feat.shape[0], feat.device, weight)


def _aligned(*tensors: torch.Tensor):
    """Contiguous copies, each checked to start on a 16-byte boundary (the
    kernels load float4 rows)."""
    out = [t.contiguous() for t in tensors]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA gather loads float4 rows: every "
                             "tensor must start on a 16-byte boundary")
    return out


def _forward(feat: torch.Tensor, pix: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    if feat.device.type == "cpu":
        return weighted_gather_sum_reference(feat, pix, weight)
    n, hw, c = feat.shape
    (feat,) = _aligned(feat)
    pix, weight = pix.contiguous(), weight.contiguous()
    n_vox = pix.shape[1]
    out = torch.empty((n_vox, c), dtype=torch.float32, device=feat.device)
    lib = _library("weighted_gather_sum")
    with torch.cuda.device(feat.device):
        err = lib.weighted_gather_sum_fwd(
            feat.data_ptr(), pix.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n, hw, n_vox, c,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_gather_sum kernel launch failed: "
                           f"cudaError {err}")
    weighted_gather_sum.launches += 1
    return out


def _check_g(g: torch.Tensor, n_vox: int, c: int):
    if g.shape != (n_vox, c):
        raise ValueError(f"g must be ({n_vox}, {c}), got {tuple(g.shape)}")
    _check_rows(g, "g")


def weighted_gather_sum_dfeat(pix: torch.Tensor, weight: torch.Tensor,
                              g: torch.Tensor, hw: int) -> torch.Tensor:
    """d-feat of `weighted_gather_sum` for the output cotangent g (V, C).

    K4 on CUDA tensors (fp32 atomics: the last bits vary from run to run),
    the plain version on CPU tensors.  Returns (N, HW, C).
    """
    _check_g(g, pix.shape[1], g.shape[-1])
    _check_pix(pix, pix.shape[0], g.device, weight)
    if pix.device.type == "cpu":
        return weighted_gather_sum_dfeat_reference(pix, weight, g, hw)
    n, n_vox = pix.shape
    c = g.shape[1]
    (g,) = _aligned(g)
    pix, weight = pix.contiguous(), weight.contiguous()
    dfeat = torch.zeros((n, hw, c), dtype=torch.float32, device=g.device)
    lib = _library("weighted_gather_sum_bwd")
    with torch.cuda.device(g.device):
        err = lib.weighted_gather_sum_dfeat(
            pix.data_ptr(), weight.data_ptr(), g.data_ptr(), dfeat.data_ptr(),
            n, hw, n_vox, c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_gather_sum_dfeat kernel launch failed: "
                           f"cudaError {err}")
    weighted_gather_sum_dfeat.launches += 1
    return dfeat


def weighted_gather_sum_dweight(feat: torch.Tensor, pix: torch.Tensor,
                                g: torch.Tensor) -> torch.Tensor:
    """d-weight of `weighted_gather_sum` for the output cotangent g (V, C).

    K5 on CUDA tensors, the plain version on CPU tensors.  Every (n, v)
    pair is computed, zero weights included.  Returns (N, V).
    """
    _check(feat, pix, None)
    n, hw, c = feat.shape
    n_vox = pix.shape[1]
    _check_g(g, n_vox, c)
    if g.device != feat.device:
        raise ValueError("feat, pix, weight and g must be on one device")
    if feat.device.type == "cpu":
        return weighted_gather_sum_dweight_reference(feat, pix, g)
    feat, g = _aligned(feat, g)
    pix = pix.contiguous()
    dw = torch.empty((n, n_vox), dtype=torch.float32, device=feat.device)
    lib = _library("weighted_gather_sum_bwd")
    with torch.cuda.device(feat.device):
        err = lib.weighted_gather_sum_dweight(
            feat.data_ptr(), pix.data_ptr(), g.data_ptr(), dw.data_ptr(),
            n, hw, n_vox, c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_gather_sum_dweight kernel launch "
                           f"failed: cudaError {err}")
    weighted_gather_sum_dweight.launches += 1
    return dw


class _WeightedGatherSum(torch.autograd.Function):
    """K3 forward; K4 (d-feat) and K5 (d-weight) backward, each run only
    when its input needs a gradient."""

    @staticmethod
    def forward(ctx, feat, pix, weight):
        ctx.save_for_backward(feat, pix, weight)
        return _forward(feat, pix, weight)

    @staticmethod
    def backward(ctx, g):
        feat, pix, weight = ctx.saved_tensors
        g = g.contiguous()
        dfeat = dweight = None
        if ctx.needs_input_grad[0]:
            dfeat = weighted_gather_sum_dfeat(pix, weight, g, feat.shape[1])
        if ctx.needs_input_grad[2]:
            dweight = weighted_gather_sum_dweight(feat, pix, g)
        return dfeat, None, dweight


def weighted_gather_sum(feat: torch.Tensor, pix: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """sum_n weight[n, v] * feat[n, pix[n, v], :] -> (V, C) float32.

    Args:
      feat: (N, HW, C) f32 per-view flattened feature maps; C % 4 == 0 on
        CUDA.
      pix: (N, V) int32 flat pixel index per voxel, clipped to [0, HW).
      weight: (N, V) f32 per-voxel weight (0 masks the row).

    Gradients reach feat and weight through the d-feat and d-weight
    kernels.
    """
    _check(feat, pix, weight)
    if torch.is_grad_enabled() and (feat.requires_grad
                                    or weight.requires_grad):
        return _WeightedGatherSum.apply(feat, pix, weight)
    return _forward(feat, pix, weight)


weighted_gather_sum.launches = 0
weighted_gather_sum_dfeat.launches = 0
weighted_gather_sum_dweight.launches = 0

_SIGNATURES = {
    "weighted_gather_sum": {"weighted_gather_sum_fwd": 4},
    "weighted_gather_sum_bwd": {"weighted_gather_sum_dfeat": 4,
                                "weighted_gather_sum_dweight": 4},
}


def _library(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu` with every entry point typed: its
    pointers, then four ints (n, hw, n_vox, c), then the stream."""
    lib = build.load(name)
    for fn_name, n_ptr in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
