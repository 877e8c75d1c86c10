"""Voxel-lift weighted gather: CUDA kernels and plain versions.

Port of mvsdet_tpu/ops/pallas/lift_kernel.py.  `weighted_gather_sum`
launches the hand-written kernel `csrc/weighted_gather_sum.cu` on CUDA
tensors and runs `weighted_gather_sum_reference` on CPU tensors.  When
feat or weight requires grad it goes through `_WeightedGatherSum`, whose
backward builds the pairs' row index once (`lift_rows`) and hands it to
`weighted_gather_sum_dfeat` and `weighted_gather_sum_dweight` (the kernels
of `csrc/weighted_gather_sum_bwd.cu` on CUDA tensors, their plain versions
on CPU tensors).  pix takes no gradient.

feat may be float32 or bfloat16 (the lift of a model computing in bf16);
weight, g and the forward's output are float32 either way, and d-feat
takes feat's dtype, as the cotangent of a bf16 input is bf16 in JAX.  A
bf16 feat on the card goes to the kernels' bf16 variants, each counted in
its wrapper's `bf16_launches` as well as in `launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvsdet_torch.ops import build

# the backward kernels hold a row in registers, up to four float4 a lane
MAX_BACKWARD_CHANNELS = 512
_INT32_MAX = 2**31 - 1
FEATURE_DTYPES = (torch.float32, torch.bfloat16)


def weighted_gather_sum_reference(feat: torch.Tensor, pix: torch.Tensor,
                                  weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather and weighted sum, views added in order n = 0..N-1
    as the XLA scan does (mvsdet_tpu/ops/voxel_lift.py:136-151); bf16 rows
    widened exactly to float32 first, as the XLA lift's float32 weights
    promote them."""
    out = torch.zeros((pix.shape[1], feat.shape[2]), dtype=torch.float32,
                      device=feat.device)
    for i in range(feat.shape[0]):
        rows = feat[i].index_select(0, pix[i].long()).to(torch.float32)
        out = out + rows * weight[i, :, None]
    return out


def weighted_gather_sum_dfeat_reference(pix: torch.Tensor,
                                        weight: torch.Tensor,
                                        g: torch.Tensor, hw: int,
                                        dtype: torch.dtype = torch.float32
                                        ) -> torch.Tensor:
    """Plain d-feat: dfeat[n, p] = sum_v [pix[n, v] = p] weight[n, v] g[v],
    one `index_add_` per view, summed in float32 and rounded once to
    ``dtype``, feat's.  Returns (N, HW, C)."""
    n = pix.shape[0]
    dfeat = torch.zeros((n, hw, g.shape[1]), dtype=torch.float32,
                        device=g.device)
    for i in range(n):
        dfeat[i].index_add_(0, pix[i].long(), g * weight[i, :, None])
    return dfeat.to(dtype)


def lift_rows_reference(pix: torch.Tensor, hw: int):
    """Plain row index of the (n, v) pairs, keyed by the flat feature row
    r = n HW + pix[n, v]: `row_start` (N HW + 1) and `pair` (N V, the flat
    pair n V + v, rows ascending and v ascending within a row), both
    int32.  Row r's pairs are pair[row_start[r]:row_start[r + 1]]."""
    n = pix.shape[0]
    keys = (torch.arange(n, device=pix.device)[:, None] * hw
            + pix.long()).flatten()
    pair = torch.argsort(keys, stable=True).to(torch.int32)
    row_start = torch.zeros(n * hw + 1, dtype=torch.int64, device=pix.device)
    row_start[1:] = torch.cumsum(torch.bincount(keys, minlength=n * hw), 0)
    return row_start.to(torch.int32), pair


def weighted_gather_sum_dfeat_rows_reference(rows, weight: torch.Tensor,
                                             g: torch.Tensor, hw: int,
                                             dtype: torch.dtype = torch.float32
                                             ) -> torch.Tensor:
    """Plain d-feat in K4's order: each row the float32 sum of
    weight[n, v] g[v] over its nonzero-weight pairs in ascending v, from 0,
    from the index `rows` of `lift_rows`, rounded once to ``dtype``.
    Returns (N, HW, C)."""
    row_start, pair = (t.long() for t in rows)
    n, n_vox = weight.shape
    n_rows = n * hw
    row = torch.repeat_interleave(torch.arange(n_rows, device=g.device),
                                  row_start.diff())
    w = weight.flatten()[pair]
    keep = w != 0
    row, vox, w = row[keep], (pair % n_vox)[keep], w[keep]
    per_row = torch.bincount(row, minlength=n_rows)
    rank = torch.arange(row.numel(), device=g.device) \
        - (torch.cumsum(per_row, 0) - per_row)[row]
    dfeat = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32,
                        device=g.device)
    for k in range(int(per_row.max()) if row.numel() else 0):
        at = rank == k                      # at most one pair per row
        dfeat[row[at]] = dfeat[row[at]] + g[vox[at]] * w[at, None]
    return dfeat.reshape(n, hw, g.shape[1]).to(dtype)


def weighted_gather_sum_dweight_reference(feat: torch.Tensor,
                                          pix: torch.Tensor,
                                          g: torch.Tensor) -> torch.Tensor:
    """Plain d-weight: dw[n, v] = <feat[n, pix[n, v]], g[v]>, (N, V)
    float32, bf16 rows widened exactly first."""
    return torch.stack([(feat[i].index_select(0, pix[i].long())
                         .to(torch.float32) * g).sum(-1)
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


def _check_rows(x: torch.Tensor, what: str, dtypes=(torch.float32,)):
    """x holds rows of C channels in one of ``dtypes``, C % 4 == 0 on the
    card (a float4, or 8 bytes of bf16, per load)."""
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"weighted_gather_sum takes {names} {what}, not "
                        f"{x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"weighted_gather_sum runs on cpu or cuda, "
                         f"not {x.device}")
    if x.device.type == "cuda" and x.shape[-1] % 4:
        raise ValueError(f"the CUDA gather loads rows 4 channels at a time: "
                         f"C={x.shape[-1]} must be a multiple of 4")


def _check(feat, pix, weight):
    if feat.ndim != 3:
        raise ValueError(f"feat must be (N, HW, C), got {tuple(feat.shape)}")
    _check_rows(feat, "feat", FEATURE_DTYPES)
    _check_pix(pix, feat.shape[0], feat.device, weight)


def _aligned(*tensors: torch.Tensor):
    """Contiguous copies, each checked to start on a 16-byte boundary (the
    kernels load rows in 8- and 16-byte pieces)."""
    out = [t.contiguous() for t in tensors]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA gather loads rows in 16-byte pieces: "
                             "every tensor must start on a 16-byte boundary")
    return out


def _count(wrapper, dtype: torch.dtype):
    wrapper.launches += 1
    if dtype == torch.bfloat16:
        wrapper.bf16_launches += 1


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
    fwd = (lib.weighted_gather_sum_fwd_bf16 if feat.dtype == torch.bfloat16
           else lib.weighted_gather_sum_fwd)
    with torch.cuda.device(feat.device):
        err = fwd(feat.data_ptr(), pix.data_ptr(), weight.data_ptr(),
                  out.data_ptr(), n, hw, n_vox, c,
                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_gather_sum kernel launch failed: "
                           f"cudaError {err}")
    _count(weighted_gather_sum, feat.dtype)
    return out


def _check_g(g: torch.Tensor, n_vox: int, c: int):
    if g.shape != (n_vox, c):
        raise ValueError(f"g must be ({n_vox}, {c}), got {tuple(g.shape)}")
    _check_rows(g, "g")
    if g.device.type == "cuda" and c > MAX_BACKWARD_CHANNELS:
        raise ValueError(f"the CUDA backward holds a row of at most "
                         f"{MAX_BACKWARD_CHANNELS} channels, got C={c}")


def _check_index_size(n: int, hw: int, n_vox: int):
    """The row index counts rows and pairs in int32."""
    if n * hw > _INT32_MAX or n * n_vox > _INT32_MAX:
        raise ValueError(f"the row index holds int32: N*HW = {n * hw} and "
                         f"N*V = {n * n_vox} must be below 2**31")


def _check_index(rows, n: int, hw: int, n_vox: int, device):
    row_start, pair = rows
    if row_start.shape != (n * hw + 1,) or pair.shape != (n * n_vox,) \
            or row_start.dtype != torch.int32 or pair.dtype != torch.int32:
        raise ValueError(f"rows must be lift_rows' int32 ({n * hw + 1},) "
                         f"row_start and ({n * n_vox},) pair")
    if row_start.device != device or pair.device != device:
        raise ValueError("rows must be on the device of pix")


def lift_rows(pix: torch.Tensor, hw: int, check: bool = False):
    """The row index of the (n, v) pairs that K4 and K5 walk:
    `(row_start, pair)`, as `lift_rows_reference` defines them.

    A counting sort on the card (`csrc/weighted_gather_sum_bwd.cu`
    `lift_rows`, no library sort; the same pix gives the same bits),
    `lift_rows_reference` on CPU tensors.  Every pix must lie in [0, hw):
    the kernel leaves a pair outside that range out, and K4 and K5 would
    then read entries of `pair` it never wrote.  `check` raises ValueError
    on such a pix first, at the cost of one read from the card.
    """
    _check_pix(pix, pix.shape[0], pix.device)
    n, n_vox = pix.shape
    _check_index_size(n, hw, n_vox)
    if check and pix.numel():
        low, high = torch.aminmax(pix)
        if low < 0 or high >= hw:
            raise ValueError(f"pix must lie in [0, {hw}), got "
                             f"[{int(low)}, {int(high)}]")
    if pix.device.type == "cpu":
        return lift_rows_reference(pix, hw)
    pix = pix.contiguous()
    row_start = torch.empty(n * hw + 1, dtype=torch.int32, device=pix.device)
    pair = torch.empty(n * n_vox, dtype=torch.int32, device=pix.device)
    lib = _library("weighted_gather_sum_bwd")
    with torch.cuda.device(pix.device):
        err = lib.lift_rows(pix.data_ptr(), row_start.data_ptr(),
                            pair.data_ptr(), n, hw, n_vox,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lift_rows kernel launch failed: cudaError {err}")
    lift_rows.launches += 1
    return row_start, pair


def weighted_gather_sum_dfeat(pix: torch.Tensor, weight: torch.Tensor,
                              g: torch.Tensor, hw: int, rows=None,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """d-feat of `weighted_gather_sum` for the output cotangent g (V, C), in
    ``dtype``, feat's (float32 or bfloat16).

    K4 on CUDA tensors: each (N, HW) row written once, the float32 sum
    over its nonzero-weight pairs in ascending v, rounded once to
    ``dtype`` (bit-equal to `weighted_gather_sum_dfeat_rows_reference`),
    from the index `rows` of `lift_rows`, built here when None.  The plain
    version on CPU tensors, which needs no index.  Returns (N, HW, C).
    """
    if dtype not in FEATURE_DTYPES:
        raise TypeError(f"d-feat is float32 or bfloat16, not {dtype}")
    _check_g(g, pix.shape[1], g.shape[-1])
    _check_pix(pix, pix.shape[0], g.device, weight)
    n, n_vox = pix.shape
    _check_index_size(n, hw, n_vox)
    if rows is not None:
        _check_index(rows, n, hw, n_vox, pix.device)
    if pix.device.type == "cpu":
        return weighted_gather_sum_dfeat_reference(pix, weight, g, hw, dtype)
    c = g.shape[1]
    row_start, pair = lift_rows(pix, hw) if rows is None else rows
    (g,) = _aligned(g)
    weight = weight.contiguous()
    dfeat = torch.empty((n, hw, c), dtype=dtype, device=g.device)
    lib = _library("weighted_gather_sum_bwd")
    dfeat_fn = (lib.weighted_gather_sum_dfeat_bf16
                if dtype == torch.bfloat16 else lib.weighted_gather_sum_dfeat)
    with torch.cuda.device(g.device):
        err = dfeat_fn(row_start.data_ptr(), pair.data_ptr(),
                       weight.data_ptr(), g.data_ptr(), dfeat.data_ptr(), n,
                       hw, n_vox, c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_gather_sum_dfeat kernel launch failed: "
                           f"cudaError {err}")
    _count(weighted_gather_sum_dfeat, dtype)
    return dfeat


def weighted_gather_sum_dweight(feat: torch.Tensor, pix: torch.Tensor,
                                g: torch.Tensor, rows=None,
                                row_loads=None) -> torch.Tensor:
    """d-weight of `weighted_gather_sum` for the output cotangent g (V, C).

    K5 on CUDA tensors, walking the index `rows` of `lift_rows` (built
    here when None), from float32 or bf16 rows; the plain version on CPU
    tensors.  Every (n, v) pair is computed, zero weights included.  `row_loads`, an int32 (1,) tensor
    on the card, takes K5's count of the feature rows it loaded, added
    on the card (CUDA only).  Returns (N, V).
    """
    _check(feat, pix, None)
    n, hw, c = feat.shape
    n_vox = pix.shape[1]
    _check_g(g, n_vox, c)
    if g.device != feat.device:
        raise ValueError("feat, pix, weight and g must be on one device")
    _check_index_size(n, hw, n_vox)
    if rows is not None:
        _check_index(rows, n, hw, n_vox, pix.device)
    if row_loads is not None and (
            row_loads.shape != (1,) or row_loads.dtype != torch.int32
            or row_loads.device != feat.device or feat.device.type != "cuda"):
        raise ValueError("row_loads must be an int32 (1,) tensor on the "
                         "card of feat: only K5 counts its row loads")
    if feat.device.type == "cpu":
        return weighted_gather_sum_dweight_reference(feat, pix, g)
    _, pair = lift_rows(pix, hw) if rows is None else rows
    feat, g = _aligned(feat, g)
    pix = pix.contiguous()
    dw = torch.empty((n, n_vox), dtype=torch.float32, device=feat.device)
    lib = _library("weighted_gather_sum_bwd")
    dweight_fn = (lib.weighted_gather_sum_dweight_bf16
                  if feat.dtype == torch.bfloat16
                  else lib.weighted_gather_sum_dweight)
    with torch.cuda.device(feat.device):
        err = dweight_fn(
            feat.data_ptr(), pix.data_ptr(), pair.data_ptr(), g.data_ptr(),
            dw.data_ptr(), None if row_loads is None else row_loads.data_ptr(),
            n, hw, n_vox, c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_gather_sum_dweight kernel launch "
                           f"failed: cudaError {err}")
    _count(weighted_gather_sum_dweight, feat.dtype)
    return dw


class _WeightedGatherSum(torch.autograd.Function):
    """K3 forward; K4 (d-feat, in feat's dtype) and K5 (d-weight) backward,
    each run only when its input needs a gradient, from one row index on
    the card."""

    @staticmethod
    def forward(ctx, feat, pix, weight):
        ctx.save_for_backward(feat, pix, weight)
        return _forward(feat, pix, weight)

    @staticmethod
    def backward(ctx, g):
        feat, pix, weight = ctx.saved_tensors
        g = g.contiguous()
        hw = feat.shape[1]
        rows = lift_rows(pix, hw) if pix.device.type == "cuda" else None
        dfeat = dweight = None
        if ctx.needs_input_grad[0]:
            dfeat = weighted_gather_sum_dfeat(pix, weight, g, hw, rows,
                                              feat.dtype)
        if ctx.needs_input_grad[2]:
            dweight = weighted_gather_sum_dweight(feat, pix, g, rows)
        return dfeat, None, dweight


def weighted_gather_sum(feat: torch.Tensor, pix: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """sum_n weight[n, v] * feat[n, pix[n, v], :] -> (V, C) float32.

    Args:
      feat: (N, HW, C) f32 or bf16 per-view flattened feature maps;
        C % 4 == 0 on CUDA.
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


weighted_gather_sum.launches = weighted_gather_sum.bf16_launches = 0
weighted_gather_sum_dfeat.launches = 0
weighted_gather_sum_dfeat.bf16_launches = 0
weighted_gather_sum_dweight.launches = 0
weighted_gather_sum_dweight.bf16_launches = 0
lift_rows.launches = 0

# each entry point's (pointers, ints), then the stream
_SIGNATURES = {
    "weighted_gather_sum": {"weighted_gather_sum_fwd": (4, 4),
                            "weighted_gather_sum_fwd_bf16": (4, 4)},
    "weighted_gather_sum_bwd": {"lift_rows": (3, 3),
                                "weighted_gather_sum_dfeat": (5, 4),
                                "weighted_gather_sum_dfeat_bf16": (5, 4),
                                "weighted_gather_sum_dweight": (6, 4),
                                "weighted_gather_sum_dweight_bf16": (6, 4)},
}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu` with every entry point typed: its
    pointers, then its ints (n, hw, n_vox, ...), then the stream."""
    lib = build.load(name)
    for fn_name, (n_ptr, n_int) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
