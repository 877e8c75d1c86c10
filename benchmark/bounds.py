"""The least time each of the port's kernels could take on the inputs it
was given, against the published H100 peaks.

Frozen copies, from commit dafa6b3, of `chip_smoke.py`'s `PEAK_BYTES_S`,
`PEAK_F32_S`, `k1_bound`, `k2_bound`, `selected_rows`, `k3_bound`,
`k4_bound`, `k5_bound`, `index_bound` and `bound` (chip_smoke.py:363,
650-753), and of what `k1_bound` and `k2_bound` read from its
`cull_check` (the active pairs and the pairs inside a kept slot's cull
box, chip_smoke.py:456-532), computed here from frozen copies of the
compositor's plain cull (`cull_boxes_reference` and the pair test of
`_pairs`, mvsdet_torch/ops/splat_kernel.py at dafa6b3).  Each bound is
the larger of bytes over peak bandwidth and operations over peak float32
rate, in milliseconds; the bytes count each input read once and each
output written once, and the operations are those these inputs need.
"""

from __future__ import annotations

import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# the compositor's constants (mvsdet_torch/ops/splat_kernel.py:35-44)
TILE = 16
PIXELS = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
MAX_COND = 1e3
LEVEL_SCALE = 2.02
LEVEL_FLOOR = 1e-5
MARGIN_PX = 1.0


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _tile_pixel_coords(n_tiles: int, tiles_x: int, device):
    t = torch.arange(n_tiles, device=device)[:, None]
    idx = torch.arange(PIXELS, device=device)[None, :]
    px = ((t % tiles_x) * TILE + idx % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + idx // TILE).to(torch.float32)
    return px, py


def cull_boxes_reference(data: torch.Tensor):
    """The kernels' cull, slot by slot: (keep (T, K), box (T, 4, K) rows
    xmin, xmax, ymin, ymax), computed in double as the kernels do."""
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


@torch.no_grad()
def cull_counts(data: torch.Tensor, tiles_x: int, step: int = 16) -> dict:
    """Active (pixel, slot) pairs and pairs inside a kept slot's cull box,
    `step` tiles at a time (`cull_check`'s two counts)."""
    n_tiles = data.shape[0]
    keep, box = cull_boxes_reference(data)
    px, py = _tile_pixel_coords(n_tiles, tiles_x, data.device)
    active = in_box = 0
    for t0 in range(0, n_tiles, step):
        d = data[t0:t0 + step, :, None, :]
        x, y = px[t0:t0 + step, :, None], py[t0:t0 + step, :, None]
        dx, dy = x - d[:, 0], y - d[:, 1]
        power = -0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy) \
            - d[:, 3] * dx * dy
        alpha = torch.clamp_max(d[:, 5] * torch.exp(power.clamp_max(0.0)),
                                ALPHA_MAX)
        act = (power <= 0) & (alpha >= ALPHA_MIN)
        b = box[t0:t0 + step, :, None, :]
        inside = keep[t0:t0 + step, None, :] & (x >= b[:, 0]) \
            & (x <= b[:, 1]) & (y >= b[:, 2]) & (y <= b[:, 3])
        active += int(act.sum())
        in_box += int(inside.sum())
    return dict(active_pairs=active, in_box_pairs=in_box)


def k1_bound(data: torch.Tensor, vals: torch.Tensor, cull: dict):
    """The compositor: each table read once and the output written once,
    against 12 flops to test a (pixel, slot) pair in a kept slot's cull
    box, plus 2C + 3 per pair that this data leaves active."""
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    ops = 12 * cull["in_box_pairs"] + (2 * c + 3) * cull["active_pairs"]
    nbytes = 4 * (data.numel() + vals.numel() + n_tiles * (c + 1) * PIXELS)
    return bound(nbytes, ops)


def k2_bound(data: torch.Tensor, vals: torch.Tensor, cull: dict):
    """The compositor's backward: the tables and the cotangent read once,
    ddata and dvals written once, against the 12-flop test per pair in a
    kept slot's box plus 4C + 34 per active pair."""
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    ops = 12 * cull["in_box_pairs"] + (4 * c + 34) * cull["active_pairs"]
    nbytes = 4 * (2 * data.numel() + 2 * vals.numel()
                  + n_tiles * (c + 1) * PIXELS)
    return bound(nbytes, ops)


def selected_rows(pix: torch.Tensor, hw: int, mask=None) -> int:
    """Distinct (view, pixel) rows that the (n, v) pairs in `mask` read."""
    n = pix.shape[0]
    flat = torch.arange(n, device=pix.device)[:, None] * hw + pix.long()
    return torch.unique(flat if mask is None else flat[mask]).numel()


def k3_bound(feat: torch.Tensor, pix: torch.Tensor, weight: torch.Tensor):
    """The gather: the feature rows its nonzero weights select, read once,
    with pix and weight, and the float32 output written once, against 2
    flops per selected value."""
    n, hw, c = feat.shape
    nz = weight != 0
    nbytes = (selected_rows(pix, hw, nz) * c * feat.element_size()
              + 4 * (2 * pix.numel() + pix.shape[1] * c))
    return bound(nbytes, 2 * c * int(nz.sum()))


def k4_bound(pix: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
             hw: int, out_bytes: int = 4):
    """d-feat: pix, weight and g read once, the (N, HW, C) output written
    once, against 2 flops per value of each nonzero-weight pair."""
    n, n_vox = pix.shape
    c = g.shape[1]
    nz = int((weight != 0).sum())
    nbytes = 4 * (2 * pix.numel() + g.numel()) + out_bytes * n * hw * c
    return bound(nbytes, 2 * c * nz)


def k5_bound(feat: torch.Tensor, pix: torch.Tensor, g: torch.Tensor):
    """d-weight: the feature rows that every pair selects, read once, with
    pix and g, and the (N, V) output written once, against 2 flops per
    value of every pair."""
    n, hw, c = feat.shape
    nbytes = (selected_rows(pix, hw) * c * feat.element_size()
              + 4 * (pix.numel() + g.numel() + pix.numel()))
    return bound(nbytes, 2 * c * pix.numel())


def index_bound(pix: torch.Tensor, hw: int):
    """The row index: pix read once, row_start and pair written once."""
    n, n_vox = pix.shape
    return bound(4 * (2 * n * n_vox + n * hw + 1), 0)
