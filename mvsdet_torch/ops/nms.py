"""3D non-maximum suppression and the IoUs of axis-aligned and yaw boxes
(port of mvsdet_tpu/ops/nms.py; reference: nerfdet_head.py:573-629, and
the ARKit head's `nms3d`, :1213-1221).

Greedy and class-aware, with a static number of picks so that the loop
never waits on the device: each pick takes the highest active score and
suppresses the same-class boxes it overlaps above the threshold.  Yaw
boxes take the exact rotated IoU (a polygon clip of the footprints); the
training loss takes a soft, sampled one that has gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvsdet_torch.models.layers import at_least, sigmoid, softplus


def aligned_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(M, N) IoU of axis-aligned corner boxes (x1 y1 z1 x2 y2 z2)."""
    lt = torch.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
    rb = torch.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
    whd = torch.clamp_min(rb - lt, 0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    vol1 = torch.prod(torch.clamp_min(boxes1[:, 3:] - boxes1[:, :3], 0.0), -1)
    vol2 = torch.prod(torch.clamp_min(boxes2[:, 3:] - boxes2[:, :3], 0.0), -1)
    union = vol1[:, None] + vol2[None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def _greedy_nms(iou: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_thr: float, valid: torch.Tensor,
                max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`max_out` greedy picks over an (M, M) IoU matrix: each takes the
    highest active score (the first of ties) and drops itself and the
    same-class boxes it overlaps above ``iou_thr``."""
    m = iou.shape[0]
    dev = iou.device
    suppress = (iou > iou_thr) & (classes[:, None] == classes[None, :])
    suppress |= torch.eye(m, dtype=torch.bool, device=dev)   # a pick drops itself
    active = torch.where(valid, scores, -torch.inf)
    keep_idx = torch.zeros(max_out, dtype=torch.int64, device=dev)
    keep_mask = torch.zeros(max_out, dtype=torch.bool, device=dev)
    for t in range(max_out):
        # a (1,) index, not a 0-dim one: indexing with a 0-dim tensor reads
        # it back to the host, a device sync per pick
        i = torch.argmax(active).reshape(1)                   # first of ties
        ok = active.index_select(0, i) > -torch.inf           # (1,)
        keep_idx[t:t + 1] = torch.where(ok, i, 0)
        keep_mask[t:t + 1] = ok
        active = torch.where(ok & suppress.index_select(0, i)[0], -torch.inf,
                             active)
    return keep_idx, keep_mask


def aligned_3d_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, iou_thr: float, valid: torch.Tensor,
                   max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy class-aware NMS on corner boxes.

    Args:
      boxes: (M, 6); scores: (M,); classes: (M,) int labels;
      valid: (M,) bool, False rows are padding or below the score
      threshold; max_out: number of picks.

    Returns:
      keep_idx: (max_out,) int64 picked indices (0 in empty slots).
      keep_mask: (max_out,) bool, which slots are real picks.
    """
    return _greedy_nms(aligned_iou_3d(boxes, boxes), scores, classes,
                       iou_thr, valid, max_out)


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(x1..z2) corners -> (cx, cy, cz, w, l, h) (nerfdet_head.py:573-578)."""
    center = (boxes[..., :3] + boxes[..., 3:]) / 2.0
    size = boxes[..., 3:] - boxes[..., :3]
    return torch.cat([center, size], dim=-1)


# -- rotated (ARKit) boxes: (cx, cy, cz, dx, dy, dz, yaw) ---------------------

def _z_overlap(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(M, N) overlap of the gravity-centred z extents."""
    z1lo = boxes1[:, 2] - boxes1[:, 5] / 2
    z1hi = boxes1[:, 2] + boxes1[:, 5] / 2
    z2lo = boxes2[:, 2] - boxes2[:, 5] / 2
    z2hi = boxes2[:, 2] + boxes2[:, 5] / 2
    return torch.clamp_min(
        torch.minimum(z1hi[:, None], z2hi[None, :])
        - torch.maximum(z1lo[:, None], z2lo[None, :]), 0.0)


def _footprint_samples(boxes7: torch.Tensor, grid: int) -> torch.Tensor:
    """(M, grid*grid, 2) BEV points: the cell centres of a grid x grid
    sampling of each box's footprint, x-major (`jnp.meshgrid(u, u,
    indexing="ij")` raveled)."""
    u = (torch.arange(grid, device=boxes7.device, dtype=torch.float32)
         + 0.5) / grid - 0.5
    ux, uy = torch.meshgrid(u, u, indexing="ij")
    unit = torch.stack([ux.reshape(-1), uy.reshape(-1)], -1)  # (G, 2)
    cos, sin = torch.cos(boxes7[:, 6]), torch.sin(boxes7[:, 6])
    scaled = unit[None] * boxes7[:, None, 3:5]                # (M, G, 2)
    return torch.stack(
        [cos[:, None] * scaled[..., 0] + (-sin)[:, None] * scaled[..., 1],
         sin[:, None] * scaled[..., 0] + cos[:, None] * scaled[..., 1]],
        -1) + boxes7[:, None, :2]


def _box_frame(pts: torch.Tensor, boxes7: torch.Tensor):
    """(x, y) of BEV points (..., G, 2) in the frames of boxes (..., 7)
    broadcast against them."""
    rel = pts - boxes7[..., None, :2]
    cos = torch.cos(boxes7[..., 6])[..., None]
    sin = torch.sin(boxes7[..., 6])[..., None]
    return (rel[..., 0] * cos + rel[..., 1] * sin,
            -rel[..., 0] * sin + rel[..., 1] * cos)


def _rotated_bev_corners(boxes7: torch.Tensor) -> torch.Tensor:
    """BEV corners of yaw boxes, counter-clockwise: (..., 4, 2)."""
    cos, sin = torch.cos(boxes7[..., 6]), torch.sin(boxes7[..., 6])
    hx, hy = boxes7[..., 3] / 2, boxes7[..., 4] / 2
    lx = torch.stack([hx, -hx, -hx, hx], -1)                 # (..., 4)
    ly = torch.stack([hy, hy, -hy, -hy], -1)
    x = cos[..., None] * lx + (-sin)[..., None] * ly
    y = sin[..., None] * lx + cos[..., None] * ly
    return torch.stack([x + boxes7[..., None, 0], y + boxes7[..., None, 1]],
                       -1)


def rotated_iou_bev_sampled(boxes1: torch.Tensor, boxes2: torch.Tensor,
                            grid: int = 16) -> torch.Tensor:
    """(M, N) approximate rotated 3D IoU: the share of a grid x grid
    sampling of each box1's footprint that falls inside box2, times box1's
    area, times the z overlap (error ~1/grid)."""
    pts = _footprint_samples(boxes1, grid)                    # (M, G, 2)
    xl, yl = _box_frame(pts[:, None], boxes2[None])           # (M, N, G)
    inside = ((xl.abs() <= boxes2[None, :, None, 3] / 2)
              & (yl.abs() <= boxes2[None, :, None, 4] / 2))
    area1 = boxes1[:, 3] * boxes1[:, 4]
    inter = inside.to(torch.float32).mean(-1) * area1[:, None] \
        * _z_overlap(boxes1, boxes2)
    vol1 = area1 * boxes1[:, 5]
    vol2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    union = vol1[:, None] + vol2[None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


_POLY_SLOTS = 8  # a 4-gon clipped by 4 half-planes has at most 8 vertices


def _successor(poly: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Each live vertex's successor, the last one wrapping to vertex 0."""
    idx = torch.arange(poly.shape[-2], device=poly.device)
    last = (idx == count[..., None] - 1)[..., None]
    return torch.where(last, poly[..., :1, :], torch.roll(poly, -1, -2))


def _inclusive_prefix(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n) ones where row <= column, in ``like``'s dtype and device:
    x @ it is the inclusive prefix sum of x along its last dimension."""
    return torch.ones(n, n, dtype=like.dtype, device=like.device).triu()


def _clip_half_plane(poly: torch.Tensor, count: torch.Tensor,
                     p0: torch.Tensor, p1: torch.Tensor):
    """One Sutherland-Hodgman step for a batch of polygons: keep the side
    left of the directed edge p0 -> p1 (the inside of a counter-clockwise
    quad).

    Each live vertex emits itself if inside and the edge's intersection on
    a crossing; the emitted candidates are compacted in polygon order into
    slots 0.., the rest of the buffer zero, as the JAX one-hot product
    leaves it (a slot takes one candidate exactly, so the scatter gives
    its bits).

    Args:
      poly: (..., S, 2) vertex buffers; count: (...,) live vertices.
      p0, p1: (..., 2) clip edge endpoints.

    Returns:
      (new_poly, new_count); the count is not capped at S.
    """
    s = poly.shape[-2]
    live = torch.arange(s, device=poly.device) < count[..., None]
    nxt = _successor(poly, count)
    ex, ey = (p1 - p0)[..., None, 0], (p1 - p0)[..., None, 1]
    x0, y0 = p0[..., None, 0], p0[..., None, 1]

    def side(q):
        return ex * (q[..., 1] - y0) - ey * (q[..., 0] - x0)

    c_in, n_in = side(poly) >= 0, side(nxt) >= 0
    d = nxt - poly
    denom = ex * d[..., 1] - ey * d[..., 0]
    denom_ok = denom.abs() > 1e-12
    t = (ex * (y0 - poly[..., 1]) - ey * (x0 - poly[..., 0])) \
        / torch.where(denom_ok, denom, 1.0)
    inter = poly + t[..., None] * d
    cand = torch.stack([poly, inter], -2).flatten(-3, -2)     # (..., 2S, 2)
    emit = torch.stack([live & c_in, live & (c_in != n_in) & denom_ok],
                       -1).flatten(-2)                        # (..., 2S)
    # the running count of emitted candidates, as a product with a
    # triangle of ones: exact (sums of at most 2S ones), and on the card
    # far faster than a cumsum along a 16-wide innermost dimension
    pos = (emit.to(poly.dtype) @ _inclusive_prefix(2 * s, poly)) \
        .to(torch.int64) - 1
    slot = torch.where(emit & (pos < s), pos, s)              # s: dropped
    out = poly.new_zeros(poly.shape[:-2] + (s + 1, 2))
    out.scatter_(-2, slot[..., None].expand(cand.shape), cand)
    return out[..., :s, :], emit.sum(-1)


def _convex_quad_intersection_area(quad1: torch.Tensor,
                                   quad2: torch.Tensor) -> torch.Tensor:
    """Exact intersection areas of convex counter-clockwise quads,
    (..., 4, 2) each -> (...)."""
    poly = torch.cat([quad1, quad1.new_zeros(
        quad1.shape[:-2] + (_POLY_SLOTS - 4, 2))], -2)
    count = torch.full(quad1.shape[:-2], 4, dtype=torch.int64,
                       device=quad1.device)
    for k in range(4):
        poly, count = _clip_half_plane(poly, count, quad2[..., k, :],
                                       quad2[..., (k + 1) % 4, :])
    nxt = _successor(poly, count)
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    live = torch.arange(_POLY_SLOTS, device=poly.device) < count[..., None]
    area = 0.5 * torch.where(live, cross, 0.0).sum(-1).abs()
    return torch.where(count >= 3, area, 0.0)


# pairs per chunk of the exact IoU: each chunk's clip buffers take
# ~0.1 KB a pair, so 2**19 pairs hold ~60 MB a buffer
_PAIRS_PER_CHUNK = 1 << 19


def rotated_iou_bev_exact(boxes1: torch.Tensor,
                          boxes2: torch.Tensor) -> torch.Tensor:
    """(M, N) exact rotated 3D IoU: the BEV polygon intersection (clipping
    box1's footprint by box2's four edges) times the z overlap, over the
    union.  The pair grid runs in chunks of rows, so that a 2,400 x 2,400
    grid holds a few hundred MB of clip buffers at a time."""
    c1 = _rotated_bev_corners(boxes1)                         # (M, 4, 2)
    c2 = _rotated_bev_corners(boxes2)                         # (N, 4, 2)
    m, n = c1.shape[0], c2.shape[0]
    rows = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    inter_bev = torch.cat([
        _convex_quad_intersection_area(
            c1[i:i + rows, None].expand(-1, n, 4, 2),
            c2[None].expand(min(rows, m - i), n, 4, 2))
        for i in range(0, m, rows)]) if m else c1.new_zeros(0, n)
    inter = inter_bev * _z_overlap(boxes1, boxes2)
    vol1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    vol2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    union = vol1[:, None] + vol2[None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def rotated_iou_3d_soft_pairs(pred7: torch.Tensor, target7: torch.Tensor,
                              grid: int = 16,
                              tau: float = 0.1) -> torch.Tensor:
    """(P,) differentiable rotated 3D IoU of matched box pairs, for the
    training loss (the reference's `RotatedIoU3DLoss`, nerfdet_head.py:71,
    647): a grid x grid sampling of pred's footprint with a sigmoid
    membership test in the target (width ``tau`` x its half-size), times a
    softplus-smoothed z overlap, clipped to [0, 1].

    Gradients follow JAX's: the maxima, minima and the clip are
    `torch.maximum`/`torch.minimum`, which split a tie's gradient in half
    as `jnp.maximum`/`jnp.clip` do (`torch.clamp` passes all of it), and
    the sigmoid and softplus are `layers.sigmoid`/`layers.softplus`.
    """
    pts = _footprint_samples(pred7, grid)                     # (P, G, 2)
    xl, yl = _box_frame(pts, target7)                         # (P, G)
    hx = at_least(target7[:, 3:4] / 2, 1e-4)                  # (P, 1)
    hy = at_least(target7[:, 4:5] / 2, 1e-4)
    sx = sigmoid((hx - xl.abs()) / (tau * hx))
    sy = sigmoid((hy - yl.abs()) / (tau * hy))
    area1 = pred7[:, 3] * pred7[:, 4]
    inter_bev = (sx * sy).mean(-1) * area1

    z1lo = pred7[:, 2] - pred7[:, 5] / 2
    z1hi = pred7[:, 2] + pred7[:, 5] / 2
    z2lo = target7[:, 2] - target7[:, 5] / 2
    z2hi = target7[:, 2] + target7[:, 5] / 2
    hz = at_least(target7[:, 5], 1e-4)
    zint = (torch.minimum(z1hi, z2hi) - torch.maximum(z1lo, z2lo)) / hz
    inter = inter_bev * (tau * softplus(zint / tau) * hz)
    vol1 = area1 * pred7[:, 5]
    vol2 = target7[:, 3] * target7[:, 4] * target7[:, 5]
    union = vol1 + vol2 - inter
    iou = inter / at_least(union, 1e-12)
    return torch.minimum(at_least(iou, 0.0), iou.new_tensor(1.0))


def rotated_3d_nms(boxes7: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, iou_thr: float, valid: torch.Tensor,
                   max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy class-aware NMS on yaw boxes (M, 7), with the exact rotated
    IoU; arguments and results as `aligned_3d_nms`."""
    return _greedy_nms(rotated_iou_bev_exact(boxes7, boxes7), scores,
                       classes, iou_thr, valid, max_out)
