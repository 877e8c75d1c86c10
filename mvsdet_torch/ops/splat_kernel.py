"""Tile-binned Gaussian-splat compositing: CUDA kernels and plain versions.

Port of mvsdet_tpu/ops/pallas/splat_kernel.py.  `composite_tiles`
launches the hand-written kernel `csrc/composite_tiles.cu` on CUDA
tensors and runs `composite_tiles_reference`, the counterpart of
`composite_tiles_xla`, on CPU tensors.  When an input requires grad it
goes through `_CompositeTiles`, whose backward is `composite_tiles_bwd`:
the kernel `csrc/composite_tiles_bwd.cu` (the port of `_bwd_kernel`) on
CUDA tensors, `composite_tiles_bwd_reference` on CPU tensors.  Tiles are
16x16 pixels; tile t sits at row t // tiles_x, column t % tiles_x of the
(possibly stacked) canvas and its pixels have integer coordinates.
"""

from __future__ import annotations

import ctypes

import torch

from mvsdet_torch.ops import build

TILE = 16
PIXELS = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0


def _tile_pixel_coords(n_tiles: int, tiles_x: int, device):
    """(T, P) integer pixel coordinates px, py of every tile's pixels."""
    t = torch.arange(n_tiles, device=device)[:, None]
    idx = torch.arange(PIXELS, device=device)[None, :]
    px = ((t % tiles_x) * TILE + idx % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + idx // TILE).to(torch.float32)
    return px, py


def composite_tiles_reference(data: torch.Tensor, vals: torch.Tensor,
                              tiles_x: int) -> torch.Tensor:
    """Plain PyTorch compositor, the same contract as `composite_tiles`.

    Exclusive log-transmittance by `torch.cumsum` over log1p(-alpha), as
    `composite_tiles_xla` does.
    """
    n_tiles = data.shape[0]
    px, py = _tile_pixel_coords(n_tiles, tiles_x, data.device)
    d = data[:, :, None, :]                                   # (T, 8, 1, K)
    dx = px[..., None] - d[:, 0]                              # (T, P, K)
    dy = py[..., None] - d[:, 1]
    power = -0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy) - d[:, 3] * dx * dy
    alpha = torch.clamp_max(d[:, 5] * torch.exp(torch.clamp_max(power, 0.0)),
                            ALPHA_MAX)
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
    lt = torch.log1p(-alpha)
    cum = torch.cumsum(lt, dim=2)
    w = torch.exp(cum - lt) * alpha                           # (T, P, K)
    out = torch.einsum("tck,tpk->tcp", vals, w)
    return torch.cat([out, torch.exp(cum[:, None, :, -1])], dim=1)


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
    with torch.cuda.device(data.device):
        err = lib.composite_tiles_fwd(
            data.data_ptr(), vals.data_ptr(), out.data_ptr(), n_tiles, k, c,
            tiles_x, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite_tiles kernel launch failed: "
                           f"cudaError {err}")
    composite_tiles.launches += 1
    return out


def composite_tiles_bwd(data: torch.Tensor, vals: torch.Tensor,
                        g: torch.Tensor, tiles_x: int):
    """Backward of `composite_tiles` for the output cotangent g.

    K2 (`csrc/composite_tiles_bwd.cu`) on CUDA tensors, the plain version
    on CPU tensors.  Returns (ddata (T, 8, K), dvals (T, C, K)); rows 6-7
    of ddata are zero.
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
    scratch = torch.empty((n_tiles, lib.composite_tiles_bwd_chunks(k), PIXELS),
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
composite_tiles_bwd.launches = 0


def _fwd_library() -> ctypes.CDLL:
    lib = build.load("composite_tiles")
    fn = lib.composite_tiles_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("composite_tiles_bwd")
    fn = lib.composite_tiles_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.composite_tiles_bwd_chunks.argtypes = [ctypes.c_int]
    lib.composite_tiles_bwd_chunks.restype = ctypes.c_int
    return lib
