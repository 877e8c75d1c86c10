"""Voxel-lift weighted gather: CUDA kernel and plain version.

Port of mvsdet_tpu/ops/pallas/lift_kernel.py (forward only).
`weighted_gather_sum` launches the hand-written kernel
`csrc/weighted_gather_sum.cu` on CUDA tensors and runs
`weighted_gather_sum_reference` on CPU tensors.  The kernel refuses
inputs that require grad until the d-feat and d-weight kernels come with
the training slice.
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


def _check(feat, pix, weight):
    if feat.ndim != 3:
        raise ValueError(f"feat must be (N, HW, C), got {tuple(feat.shape)}")
    n = feat.shape[0]
    if pix.ndim != 2 or pix.shape[0] != n or weight.shape != pix.shape:
        raise ValueError(f"pix and weight must both be (N={n}, V), got "
                         f"{tuple(pix.shape)} and {tuple(weight.shape)}")
    if feat.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError("weighted_gather_sum takes float32 feat and weight")
    if pix.dtype != torch.int32:
        raise TypeError(f"pix must be int32, got {pix.dtype}")
    if not feat.device == pix.device == weight.device:
        raise ValueError("feat, pix and weight must be on one device")


def weighted_gather_sum(feat: torch.Tensor, pix: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """sum_n weight[n, v] * feat[n, pix[n, v], :] -> (V, C) float32.

    Args:
      feat: (N, HW, C) f32 per-view flattened feature maps; C % 4 == 0 on
        CUDA.
      pix: (N, V) int32 flat pixel index per voxel, clipped to [0, HW).
      weight: (N, V) f32 per-voxel weight (0 masks the row).
    """
    _check(feat, pix, weight)
    if feat.device.type == "cpu":
        return weighted_gather_sum_reference(feat, pix, weight)
    if feat.device.type != "cuda":
        raise ValueError(f"weighted_gather_sum runs on cpu or cuda, "
                         f"not {feat.device}")
    if feat.requires_grad or weight.requires_grad:
        raise RuntimeError("the weighted_gather_sum CUDA kernel is "
                           "forward-only; its backward (d-feat, d-weight) "
                           "comes with the training slice")
    n, hw, c = feat.shape
    if c % 4:
        raise ValueError(f"the CUDA gather loads float4 rows: C={c} must be "
                         f"a multiple of 4")
    feat, pix, weight = feat.contiguous(), pix.contiguous(), weight.contiguous()
    if feat.data_ptr() % 16:
        raise ValueError("the CUDA gather loads float4 rows: feat must start "
                         "on a 16-byte boundary")
    n_vox = pix.shape[1]
    out = torch.empty((n_vox, c), dtype=torch.float32, device=feat.device)
    lib = _library()
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


weighted_gather_sum.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("weighted_gather_sum")
    fn = lib.weighted_gather_sum_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
