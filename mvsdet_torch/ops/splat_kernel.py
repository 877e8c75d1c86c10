"""Tile-binned Gaussian-splat compositing: CUDA kernel and plain version.

Port of mvsdet_tpu/ops/pallas/splat_kernel.py.  `composite_tiles`
launches the hand-written kernel `csrc/composite_tiles.cu` on CUDA
tensors and runs `composite_tiles_reference`, the counterpart of
`composite_tiles_xla`, on CPU tensors.  Tiles are 16x16 pixels; tile t
sits at row t // tiles_x, column t % tiles_x of the (possibly stacked)
canvas and its pixels have integer coordinates.

This slice is forward only: the kernel refuses inputs that require grad
until the analytic backward (the port of `_bwd_kernel`) comes with the
training slice, so no gradient can silently go wrong.
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
    if tiles_x < 1:
        raise ValueError(f"tiles_x must be positive, got {tiles_x}")


def composite_tiles(data: torch.Tensor, vals: torch.Tensor,
                    tiles_x: int) -> torch.Tensor:
    """Composite per-tile gaussian tables into tile images.

    Args:
      data: (T, 8, K) f32 rows [mx, my, conic_a, conic_b, conic_c,
        opacity, pad, pad]; empty slots have opacity 0.
      vals: (T, C, K) f32 per-slot channel values, C in 1..4 on CUDA.
      tiles_x: tiles per canvas row.

    Returns:
      (T, C + 1, 256): channels, then the final transmittance.
    """
    _check(data, vals, tiles_x)
    if data.device.type == "cpu":
        return composite_tiles_reference(data, vals, tiles_x)
    if data.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on cpu or cuda, "
                         f"not {data.device}")
    if data.requires_grad or vals.requires_grad:
        raise RuntimeError("the composite_tiles CUDA kernel is forward-only; "
                           "its backward comes with the training slice")
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    if not 1 <= c <= 4:
        raise ValueError(f"the CUDA compositor takes 1..4 channels, got {c}")
    data = data.contiguous()
    vals = vals.contiguous()
    out = torch.empty((n_tiles, c + 1, PIXELS), dtype=torch.float32,
                      device=data.device)
    lib = _library()
    with torch.cuda.device(data.device):
        err = lib.composite_tiles_fwd(
            data.data_ptr(), vals.data_ptr(), out.data_ptr(), n_tiles, k, c,
            tiles_x, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite_tiles kernel launch failed: "
                           f"cudaError {err}")
    composite_tiles.launches += 1
    return out


composite_tiles.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("composite_tiles")
    fn = lib.composite_tiles_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
