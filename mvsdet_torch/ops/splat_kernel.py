"""Tile-binned Gaussian-splat compositing: CUDA kernels and plain versions.

Port of mvsdet_tpu/ops/pallas/splat_kernel.py.  `composite_tiles`
launches the hand-written kernels of `csrc/composite_tiles.cu` on CUDA
tensors and runs `composite_tiles_reference`, the counterpart of
`composite_tiles_xla`, on CPU tensors.  When an input requires grad it
goes through `_CompositeTiles`, whose backward is `composite_tiles_bwd`:
the kernels of `csrc/composite_tiles_bwd.cu` (the port of `_bwd_kernel`)
on CUDA tensors, `composite_tiles_bwd_reference` on CPU tensors.  Tiles
are 16x16 pixels; tile t sits at row t // tiles_x, column t % tiles_x of
the (possibly stacked) canvas and its pixels have integer coordinates.

The CUDA kernels split K into segments of `SEGMENT` slots, one CTA each,
and cull with a box per slot (`csrc/composite_tiles.cuh`).  The libraries
export the constants they were built with, and the wrappers refuse one
that differs from `KERNEL_CONSTANTS`; `cull_boxes` gives the kernels' own
boxes, for the checks.  Their arithmetic has plain versions here too, for
the CPU tests: `cull_boxes_reference` (the boxes),
`segment_partials_reference` and `combine_segments_reference` (the
forward's two passes), `segment_states_reference` and
`composite_tiles_bwd_segmented_reference` (the backward's start states and
its walk from them).  Each wrapper counts its kernel launches in
`launches`; `composite_tiles.c1_launches` counts those with one channel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvsdet_torch.ops import build

TILE = 16
PIXELS = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
SEGMENT = 128            # slots per CTA of the CUDA kernels (kSeg)
# the cull box's slack, as `csrc/composite_tiles.cuh` sets it
MAX_COND = 1e3
LEVEL_SCALE = 2.02
LEVEL_FLOOR = 1e-5
MARGIN_PX = 1.0
# the values each compositor library exports (`composite_tiles_constants`)
# and must agree with, in its order
KERNEL_CONSTANTS = (SEGMENT, float(torch.tensor(ALPHA_MIN)),
                    float(torch.tensor(ALPHA_MAX)), MAX_COND, LEVEL_SCALE,
                    LEVEL_FLOOR, MARGIN_PX)


def _tile_pixel_coords(n_tiles: int, tiles_x: int, device):
    """(T, P) integer pixel coordinates px, py of every tile's pixels."""
    t = torch.arange(n_tiles, device=device)[:, None]
    idx = torch.arange(PIXELS, device=device)[None, :]
    px = ((t % tiles_x) * TILE + idx % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + idx // TILE).to(torch.float32)
    return px, py


def _pairs(data: torch.Tensor, tiles_x: int):
    """Per (tile, pixel, slot): dx, dy, power, exp(min(power, 0)), the
    unclipped alpha, the active mask and alpha (0 where not active)."""
    n_tiles = data.shape[0]
    px, py = _tile_pixel_coords(n_tiles, tiles_x, data.device)
    d = data[:, :, None, :]                                   # (T, 8, 1, K)
    dx = px[..., None] - d[:, 0]                              # (T, P, K)
    dy = py[..., None] - d[:, 1]
    power = -0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy) - d[:, 3] * dx * dy
    exp_p = torch.exp(torch.clamp_max(power, 0.0))
    alpha_un = d[:, 5] * exp_p
    alpha_cl = torch.clamp_max(alpha_un, ALPHA_MAX)
    active = (power <= 0.0) & (alpha_cl >= ALPHA_MIN)
    alpha = torch.where(active, alpha_cl, 0.0)
    return dx, dy, power, exp_p, alpha_un, active, alpha


def composite_tiles_reference(data: torch.Tensor, vals: torch.Tensor,
                              tiles_x: int) -> torch.Tensor:
    """Plain PyTorch compositor, the same contract as `composite_tiles`.

    Exclusive log-transmittance by `torch.cumsum` over log1p(-alpha), as
    `composite_tiles_xla` does.
    """
    alpha = _pairs(data, tiles_x)[-1]
    lt = torch.log1p(-alpha)
    cum = torch.cumsum(lt, dim=2)
    w = torch.exp(cum - lt) * alpha                           # (T, P, K)
    out = torch.einsum("tck,tpk->tcp", vals, w)
    return torch.cat([out, torch.exp(cum[:, None, :, -1])], dim=1)


def cull_boxes_reference(data: torch.Tensor):
    """The CUDA kernels' cull, slot by slot: (keep (T, K) bool, box
    (T, 4, K) float32 rows xmin, xmax, ymin, ymax).

    A slot with opacity below 1/255 is never active (alpha <= opacity) and
    is not kept.  A kept slot is active only inside its box: the ellipse
    op exp(power) >= 1/255, taken at the level LEVEL_SCALE tau +
    LEVEL_FLOOR of the quadratic form (tau = ln(op / (1/255))) against the
    float rounding of the per-pixel test and widened by MARGIN_PX, computed
    in double as the kernels do.  A conic that is not positive definite or
    worse conditioned than MAX_COND, or a number that is not finite, gets
    an unbounded box.
    """
    keep = ~(data[:, 5] < ALPHA_MIN)
    d = data[:, :6].double()
    mx, my, a, b, c, op = d.unbind(1)
    det = a * c - b * b
    ok = (torch.isfinite(d).all(dim=1) & (a > 0) & (det > 0)
          & (a * c <= MAX_COND * det))
    alpha_min = torch.tensor(ALPHA_MIN, dtype=torch.float32).double()
    tau = torch.clamp_min(torch.log(op / alpha_min), 0.0)
    level = LEVEL_SCALE * tau + LEVEL_FLOOR
    hx = torch.sqrt(level * c / det) + MARGIN_PX
    hy = torch.sqrt(level * a / det) + MARGIN_PX
    inf = torch.full_like(mx, torch.inf)
    box = torch.stack([torch.where(ok, mx - hx, -inf),
                       torch.where(ok, mx + hx, inf),
                       torch.where(ok, my - hy, -inf),
                       torch.where(ok, my + hy, inf)], dim=1)
    return keep, box.float()


def cull_boxes(data: torch.Tensor):
    """The kernels' own cull of these tables, like `cull_boxes_reference`.

    On CUDA tensors the boxes come from the device function the kernels
    stage with (`composite_tiles_cull_boxes`, an inspection launch, not
    part of the compositing path), so a check of them checks the kernels'
    cull; on CPU tensors from `cull_boxes_reference`.
    """
    if data.ndim != 3 or data.shape[1] != 8 or data.dtype != torch.float32:
        raise ValueError(f"data must be float32 (T, 8, K), got {data.dtype} "
                         f"{tuple(data.shape)}")
    if data.device.type == "cpu":
        return cull_boxes_reference(data)
    data = data.contiguous()
    n_tiles, _, k = data.shape
    keep = torch.empty((n_tiles, k), dtype=torch.bool, device=data.device)
    box = torch.empty((n_tiles, 4, k), dtype=torch.float32,
                      device=data.device)
    with torch.cuda.device(data.device):
        err = _fwd_library().composite_tiles_cull_boxes(
            data.data_ptr(), keep.data_ptr(), box.data_ptr(), n_tiles, k,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite_tiles_cull_boxes launch failed: "
                           f"cudaError {err}")
    return keep, box


def segment_partials_reference(data: torch.Tensor, vals: torch.Tensor,
                               tiles_x: int, segment: int = SEGMENT):
    """The forward's first pass: per tile, segment of `segment` slots
    (the last may be shorter) and pixel, the channels composited from a
    local log-transmittance of 0 and the segment's sum L_s of
    log1p(-alpha).  Returns (T, S, C + 1, 256)."""
    alpha = _pairs(data, tiles_x)[-1]
    lt = torch.log1p(-alpha)
    parts = []
    for b in range(0, data.shape[2], segment):
        a_s, lt_s = alpha[..., b:b + segment], lt[..., b:b + segment]
        cum = torch.cumsum(lt_s, dim=2)
        w = torch.exp(cum - lt_s) * a_s
        acc = torch.einsum("tck,tpk->tcp", vals[..., b:b + segment], w)
        parts.append(torch.cat([acc, cum[:, None, :, -1]], dim=1))
    return torch.stack(parts, dim=1)


def combine_segments_reference(partials: torch.Tensor) -> torch.Tensor:
    """The forward's second pass, in segment order: out_c = sum_s
    exp(sum_{s'<s} L_s') acc_sc and T_final = exp(sum_s L_s)."""
    log_l = partials[:, :, -1]                                # (T, S, P)
    pre = torch.cumsum(log_l, dim=1) - log_l
    out = (torch.exp(pre)[:, :, None] * partials[:, :, :-1]).sum(dim=1)
    return torch.cat([out, torch.exp(log_l.sum(dim=1))[:, None]], dim=1)


def segment_states_reference(partials: torch.Tensor, g: torch.Tensor):
    """The backward's start state of every segment, from the forward's
    partials and the cotangent g (T, C + 1, 256): (start log-T
    sum_{s'<s} L_s', start suffix sum_{s'>s} exp(sum_{s''<s'} L_s'') U_s'
    + g_T T_final), each (T, S, 256), with U_s = sum_c g_c acc_sc."""
    log_l = partials[:, :, -1]
    pre = torch.cumsum(log_l, dim=1) - log_l
    u = torch.einsum("tscp,tcp->tsp", partials[:, :, :-1], g[:, :-1])
    part = torch.exp(pre) * u
    suffix = part.flip(1).cumsum(dim=1).flip(1) - part
    tail = g[:, -1] * torch.exp(log_l.sum(dim=1))             # g_T T_final
    return pre, suffix + tail[:, None]


def composite_tiles_bwd_segmented_reference(data: torch.Tensor,
                                            vals: torch.Tensor,
                                            g: torch.Tensor, tiles_x: int,
                                            segment: int = SEGMENT):
    """The backward in the CUDA kernel's order, in plain PyTorch: the
    segment partials, each segment's start state, then the analytic
    gradient within each segment from that state, chained through the
    forward's masks as `_bwd_kernel` does.  Returns (ddata, dvals) like
    `composite_tiles_bwd_reference`."""
    c = vals.shape[1]
    dx, dy, power, exp_p, alpha_un, active, alpha = _pairs(data, tiles_x)
    pre, start = segment_states_reference(
        segment_partials_reference(data, vals, tiles_x, segment), g)
    u = torch.einsum("tck,tcp->tpk", vals, g[:, :c])          # (T, P, K)
    lt = torch.log1p(-alpha)
    dalpha, w = [], []
    for s, b in enumerate(range(0, data.shape[2], segment)):
        sl = slice(b, b + segment)
        cum = torch.cumsum(lt[..., sl], dim=2)
        t_excl = torch.exp(pre[:, s, :, None] + cum - lt[..., sl])
        w_s = t_excl * alpha[..., sl]
        wu = w_s * u[..., sl]
        after = wu.flip(2).cumsum(dim=2).flip(2) - wu        # i > j in s
        dalpha.append(t_excl * u[..., sl] - (start[:, s, :, None] + after)
                      / (1.0 - alpha[..., sl]))
        w.append(w_s)
    dalpha, w = torch.cat(dalpha, dim=2), torch.cat(w, dim=2)
    d_alpha_un = torch.where(active & (alpha_un < ALPHA_MAX), dalpha, 0.0)
    d_power = torch.where(power < 0.0, d_alpha_un * alpha_un, 0.0)
    ca, cb, cc = (data[:, r, None, :] for r in (2, 3, 4))
    ddata = torch.zeros_like(data)
    ddata[:, 0] = (d_power * (ca * dx + cb * dy)).sum(dim=1)
    ddata[:, 1] = (d_power * (cc * dy + cb * dx)).sum(dim=1)
    ddata[:, 2] = (d_power * (-0.5 * dx * dx)).sum(dim=1)
    ddata[:, 3] = (d_power * (-dx * dy)).sum(dim=1)
    ddata[:, 4] = (d_power * (-0.5 * dy * dy)).sum(dim=1)
    ddata[:, 5] = (d_alpha_un * exp_p).sum(dim=1)
    dvals = torch.einsum("tcp,tpk->tck", g[:, :c], w)
    return ddata, dvals


def composite_tiles_bwd_reference(data: torch.Tensor, vals: torch.Tensor,
                                  g: torch.Tensor, tiles_x: int):
    """Plain backward: autograd of `composite_tiles_reference`.

    Returns (ddata (T, 8, K), dvals (T, C, K)) for the output cotangent
    g (T, C + 1, 256).
    """
    with torch.enable_grad():
        d = data.detach().requires_grad_(True)
        v = vals.detach().requires_grad_(True)
        out = composite_tiles_reference(d, v, tiles_x)
        ddata, dvals = torch.autograd.grad(out, (d, v), g)
    return ddata, dvals


def _check(data: torch.Tensor, vals: torch.Tensor, tiles_x: int):
    if data.ndim != 3 or data.shape[1] != 8:
        raise ValueError(f"data must be (T, 8, K), got {tuple(data.shape)}")
    if vals.ndim != 3 or vals.shape[0] != data.shape[0] \
            or vals.shape[2] != data.shape[2]:
        raise ValueError(f"vals must be (T, C, K) beside data "
                         f"{tuple(data.shape)}, got {tuple(vals.shape)}")
    if data.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("composite_tiles takes float32 data and vals")
    if data.device != vals.device:
        raise ValueError("data and vals must be on one device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"composite_tiles runs on cpu or cuda, "
                         f"not {data.device}")
    if tiles_x < 1:
        raise ValueError(f"tiles_x must be positive, got {tiles_x}")
    if data.device.type == "cuda" and not 1 <= vals.shape[1] <= 4:
        raise ValueError(f"the CUDA compositor takes 1..4 channels, "
                         f"got {vals.shape[1]}")


def _forward(data: torch.Tensor, vals: torch.Tensor,
             tiles_x: int) -> torch.Tensor:
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if data.device.type == "cpu":
        return composite_tiles_reference(data, vals, tiles_x)
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    data = data.contiguous()
    vals = vals.contiguous()
    out = torch.empty((n_tiles, c + 1, PIXELS), dtype=torch.float32,
                      device=data.device)
    lib = _fwd_library()
    scratch = torch.empty(lib.composite_tiles_fwd_scratch(n_tiles, k, c),
                          dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        err = lib.composite_tiles_fwd(
            data.data_ptr(), vals.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n_tiles, k, c, tiles_x,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite_tiles kernel launch failed: "
                           f"cudaError {err}")
    composite_tiles.launches += 1
    if c == 1:
        composite_tiles.c1_launches += 1
    return out


def composite_tiles_bwd(data: torch.Tensor, vals: torch.Tensor,
                        g: torch.Tensor, tiles_x: int):
    """Backward of `composite_tiles` for the output cotangent g.

    K2 (`csrc/composite_tiles_bwd.cu`) on CUDA tensors, the plain version
    on CPU tensors.  Returns (ddata (T, 8, K), dvals (T, C, K)); rows 6-7
    of ddata are zero.  K2 runs the forward's segment pass again for the
    segments' start states rather than taking them from the forward, so
    this call stands alone and the training step and a direct call do the
    same work.
    """
    _check(data, vals, tiles_x)
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    if g.shape != (n_tiles, c + 1, PIXELS) or g.dtype != torch.float32 \
            or g.device != data.device:
        raise ValueError(f"g must be float32 ({n_tiles}, {c + 1}, {PIXELS}) "
                         f"on {data.device}, got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}")
    if data.device.type == "cpu":
        return composite_tiles_bwd_reference(data, vals, g, tiles_x)
    data, vals, g = data.contiguous(), vals.contiguous(), g.contiguous()
    ddata = torch.empty_like(data)
    dvals = torch.empty_like(vals)
    lib = _bwd_library()
    scratch = torch.empty(lib.composite_tiles_bwd_scratch(n_tiles, k, c),
                          dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        err = lib.composite_tiles_bwd(
            data.data_ptr(), vals.data_ptr(), g.data_ptr(), ddata.data_ptr(),
            dvals.data_ptr(), scratch.data_ptr(), n_tiles, k, c, tiles_x,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite_tiles_bwd kernel launch failed: "
                           f"cudaError {err}")
    composite_tiles_bwd.launches += 1
    return ddata, dvals


class _CompositeTiles(torch.autograd.Function):
    """K1 forward, K2 backward (the custom VJP of the JAX kernel)."""

    @staticmethod
    def forward(ctx, data, vals, tiles_x):
        ctx.save_for_backward(data, vals)
        ctx.tiles_x = tiles_x
        return _forward(data, vals, tiles_x)

    @staticmethod
    def backward(ctx, g):
        data, vals = ctx.saved_tensors
        ddata, dvals = composite_tiles_bwd(data, vals, g.contiguous(),
                                           ctx.tiles_x)
        return ddata, dvals, None


def composite_tiles(data: torch.Tensor, vals: torch.Tensor,
                    tiles_x: int) -> torch.Tensor:
    """Composite per-tile gaussian tables into tile images.

    Args:
      data: (T, 8, K) f32 rows [mx, my, conic_a, conic_b, conic_c,
        opacity, pad, pad]; empty slots have opacity 0.
      vals: (T, C, K) f32 per-slot channel values, C in 1..4 on CUDA.
      tiles_x: tiles per canvas row.

    Returns:
      (T, C + 1, 256): channels, then the final transmittance.  Gradients
      reach data and vals through `composite_tiles_bwd`.
    """
    _check(data, vals, tiles_x)
    if torch.is_grad_enabled() and (data.requires_grad or vals.requires_grad):
        return _CompositeTiles.apply(data, vals, tiles_x)
    return _forward(data, vals, tiles_x)


composite_tiles.launches = 0
# the one-channel launches among them (the predict's rendered depth)
composite_tiles.c1_launches = 0
composite_tiles_bwd.launches = 0


def kernel_constants(lib: ctypes.CDLL) -> tuple:
    """The constants a compositor library was built with, in the order of
    KERNEL_CONSTANTS."""
    out = (ctypes.c_double * len(KERNEL_CONSTANTS))()
    lib.composite_tiles_constants.argtypes = [ctypes.c_void_p]
    lib.composite_tiles_constants.restype = None
    lib.composite_tiles_constants(out)
    return tuple(out)


def _checked(name: str) -> ctypes.CDLL:
    """The loaded library `name`, refused if its constants are not the
    plain versions' (`KERNEL_CONSTANTS`)."""
    lib = build.load(name)
    got = kernel_constants(lib)
    if got != KERNEL_CONSTANTS:
        raise RuntimeError(f"{name} was built with the constants {got}, "
                           f"the plain versions use {KERNEL_CONSTANTS}")
    return lib


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = _checked("composite_tiles")
    fn = lib.composite_tiles_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.composite_tiles_fwd_scratch.argtypes = [ctypes.c_int] * 3
    lib.composite_tiles_fwd_scratch.restype = ctypes.c_longlong
    lib.composite_tiles_cull_boxes.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.composite_tiles_cull_boxes.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _checked("composite_tiles_bwd")
    fn = lib.composite_tiles_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.composite_tiles_bwd_scratch.argtypes = [ctypes.c_int] * 3
    lib.composite_tiles_bwd_scratch.restype = ctypes.c_longlong
    return lib
