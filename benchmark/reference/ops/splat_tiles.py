# Frozen copy of mvsdet_torch/ops/splat_tiles.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.  The compositor is the plain
# `composite_tiles_reference` of mvsdet_torch/ops/splat_kernel.py at the
# same commit, differentiated by autograd.
"""Tile-binned Gaussian-splat renderer (port of mvsdet_tpu/ops/splat_tiles.py).

Project -> compute splat radii -> bin gaussians into 16x16 pixel tiles
with a fixed per-tile capacity (the nearest `capacity` splats, after one
global depth sort) -> composite every tile of every target view at
once, on a canvas of the views stacked vertically (`render_views_tiled`),
front to back with the 0.99 alpha clamp and the 1/255 cutoff.  A Gaussian reaches only the
tiles its 3-sigma radius meets, as in the CUDA rasterizer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.geometry.sh import eval_sh_color
from benchmark.reference.ops.splat import project_gaussians

TILE = 16
PIXELS = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0


def composite_tiles(data: torch.Tensor, vals: torch.Tensor,
                    tiles_x: int) -> torch.Tensor:
    """Composite per-tile gaussian tables, data (T, 8, K) and vals
    (T, C, K), into tile images (T, C + 1, 256): the channels, then the
    final transmittance.  Tile t sits at row t // tiles_x, column
    t % tiles_x of the canvas, and its pixels have integer coordinates.
    Exclusive log-transmittance by `torch.cumsum` over log1p(-alpha), as
    `composite_tiles_xla` does."""
    n_tiles = data.shape[0]
    t = torch.arange(n_tiles, device=data.device)[:, None]
    idx = torch.arange(PIXELS, device=data.device)[None, :]
    px = ((t % tiles_x) * TILE + idx % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + idx // TILE).to(torch.float32)
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


def splat_radii(cov_tri: torch.Tensor) -> torch.Tensor:
    """3-sigma splat radius in pixels from the 2D covariance (the CUDA
    rasterizer's eigenvalue bound)."""
    a, b, c = cov_tri[:, 0], cov_tri[:, 1], cov_tri[:, 2]
    mid = 0.5 * (a + c)
    det = a * c - b * b
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    return torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))


def bin_gaussians(mean2d: torch.Tensor, radius: torch.Tensor,
                  valid: torch.Tensor, tiles_y: int, tiles_x: int,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity per-tile index lists, nearest first.

    Inputs are already depth-sorted, so the first `capacity` overlapping
    gaussians of a tile are its nearest.  The top-k scores are -position,
    unique apart from the sentinel of non-overlapping entries, whose slots
    are all empty, so `torch.topk`'s order among ties does not matter.

    Returns:
      idx: (n_tiles, capacity) int64 indices into the sorted arrays.
      slot_valid: (n_tiles, capacity) bool, False for empty slots.
    """
    g = mean2d.shape[0]
    dev = mean2d.device
    x0 = torch.floor((mean2d[:, 0] - radius) / TILE).to(torch.int64)
    x1 = torch.floor((mean2d[:, 0] + radius) / TILE).to(torch.int64)
    y0 = torch.floor((mean2d[:, 1] - radius) / TILE).to(torch.int64)
    y1 = torch.floor((mean2d[:, 1] + radius) / TILE).to(torch.int64)
    txs = torch.arange(tiles_x, device=dev)
    tys = torch.arange(tiles_y, device=dev)
    mask_x = (txs[None, :] >= x0[:, None]) & (txs[None, :] <= x1[:, None])
    mask_y = (tys[None, :] >= y0[:, None]) & (tys[None, :] <= y1[:, None])
    mask = (mask_y[:, :, None] & mask_x[:, None, :] & valid[:, None, None])
    mask = mask.reshape(g, tiles_y * tiles_x).T               # (T, G)
    score = torch.where(mask, -torch.arange(g, device=dev)[None, :], -(g + 1))
    top = torch.topk(score, min(capacity, g), dim=1).values   # descending
    idx = -top                                                # ascending
    slot_valid = idx < g
    idx = torch.clamp_max(idx, g - 1)
    if capacity > g:
        pad = capacity - g
        idx = torch.nn.functional.pad(idx, (0, pad))
        slot_valid = torch.nn.functional.pad(slot_valid, (0, pad))
    return idx, slot_valid


def _tile_tables(means, covariances, values, opacities, c2w,
                 intrinsics_norm, image_shape, capacity: int,
                 near_clip: float):
    """Project, depth-sort and bin one view into fixed-capacity tile tables.

    Returns:
      data: (n_tiles, 8, cap) kernel rows; vals: (n_tiles, C, cap).
    """
    h, w = image_shape
    tiles_y = -(-h // TILE)
    tiles_x = -(-w // TILE)
    mean2d, conic, z, valid, cov_tri = project_gaussians(
        means, covariances, c2w, intrinsics_norm, image_shape, near_clip)

    g = means.shape[0]
    n_ch = values.shape[-1]
    # stable, as jnp.argsort is: ties keep their gaussian order (trap T5)
    order = torch.argsort(torch.where(valid, z, torch.inf), stable=True)
    packed = torch.cat([
        mean2d, conic, torch.where(valid, opacities, 0.0)[:, None],
        torch.zeros((g, 2), dtype=mean2d.dtype, device=mean2d.device),
        values,
    ], dim=1)[order]                                          # (G, 8+C)
    rad_s = splat_radii(cov_tri)[order]

    idx, slot_valid = bin_gaussians(packed[:, :2], rad_s, valid[order],
                                    tiles_y, tiles_x, capacity)
    rows = packed[idx]                                        # (T, cap, 8+C)
    rows = torch.where(slot_valid[..., None], rows, 0.0)      # empty -> 0
    data = rows[..., :8].transpose(1, 2)                      # (T, 8, cap)
    vals = rows[..., 8:8 + n_ch].transpose(1, 2)              # (T, C, cap)
    return data, vals


def _sh_values(means, harmonics, c2w):
    """Per-gaussian SH colour seen from one camera, (G, 3)."""
    dirs = means - c2w[:3, 3]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    return eval_sh_color(harmonics, dirs)


def _assemble_tiles(out, tiles_y, tiles_x, n_ch, h, w, background):
    """(n_tiles, C+1, P) compositor output -> (H, W, C) over background."""
    out = out.reshape(tiles_y, tiles_x, n_ch + 1, TILE, TILE)
    out = out.permute(0, 3, 1, 4, 2).reshape(
        tiles_y * TILE, tiles_x * TILE, n_ch + 1)[:h, :w]
    rgb, t_final = out[..., :n_ch], out[..., n_ch:]
    return rgb + t_final * background[None, None, :]


def render_views_tiled(means, covariances, harmonics, opacities, c2ws,
                       intrinsics_norm, image_shape,
                       background: Optional[torch.Tensor] = None,
                       capacity: int = 1024,
                       near_clip: float = 0.2) -> torch.Tensor:
    """Render every target view in one compositor call, (T, H, W, 3).

    View t's 2D means are shifted by t * tiles_y * 16 in y, so the
    concatenated tile list reads to the compositor's `t // tiles_x` pixel
    map as one tall canvas of vertically stacked views; the shift cancels
    in the compositor's dx, dy.  Gradients reach the Gaussians through
    the compositor, the tile-table gather and the shift; the
    binning (which slots a Gaussian fills) takes none, as under JAX's
    `stop_gradient`.

    Args:
      c2ws: (T, 4, 4); intrinsics_norm: (T, 3, 3) normalised K.
    """
    h, w = image_shape
    tiles_y = -(-h // TILE)
    tiles_x = -(-w // TILE)
    t_views = c2ws.shape[0]
    n_ch = 3
    if background is None:
        background = torch.zeros(n_ch, dtype=torch.float32,
                                 device=means.device)

    datas, valss = [], []
    for t in range(t_views):
        values = _sh_values(means, harmonics, c2ws[t])
        data, vals = _tile_tables(means, covariances, values, opacities,
                                  c2ws[t], intrinsics_norm[t], image_shape,
                                  capacity, near_clip)
        data = data.clone()
        data[:, 1, :] += float(t * tiles_y * TILE)            # shift my
        datas.append(data)
        valss.append(vals)
    n_tiles = tiles_y * tiles_x
    out = composite_tiles(torch.cat(datas).contiguous(),
                          torch.cat(valss).contiguous(), tiles_x)
    out = out.reshape(t_views, n_tiles, n_ch + 1, TILE * TILE)
    return torch.stack([
        _assemble_tiles(out[t], tiles_y, tiles_x, n_ch, h, w, background)
        for t in range(t_views)
    ])
