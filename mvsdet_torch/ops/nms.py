"""3D non-maximum suppression and the IoUs of axis-aligned and yaw boxes
(port of mvsdet_tpu/ops/nms.py; reference: nerfdet_head.py:573-629, and
the ARKit head's `nms3d`, :1213-1221).

Greedy and class-aware, with a static number of picks so that the loop
never waits on the device: each pick takes the highest active score and
suppresses the same-class boxes it overlaps above the threshold.  Yaw
boxes take the exact rotated IoU (a polygon clip of the footprints); the
training loss takes a soft, sampled one that has gradients.

`aligned_3d_nms` and `rotated_3d_nms` run the hand-written kernels of
`csrc/nms3d.cu` (`nms3d`: the suppression mask, then the greedy picks in
one block, two launches) when the boxes are on the card, in float32,
float64, bfloat16 or float16, each computing the IoU as the plain
version computes it in that dtype; on the CPU they run the plain
version (`aligned_3d_nms_reference`, `rotated_3d_nms_reference`:
`_greedy_nms` over the IoU matrix).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from mvsdet_torch.models.layers import at_least, sigmoid, softplus
from mvsdet_torch.ops import build

# the boxes' dtypes the kernels take, by their code in csrc/nms3d.cu
_BOX_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.float16: 3}


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
    if _on_card(boxes):
        return nms3d(boxes, scores, classes, iou_thr, valid, max_out,
                     rotated=False)
    return aligned_3d_nms_reference(boxes, scores, classes, iou_thr, valid,
                                    max_out)


def aligned_3d_nms_reference(boxes: torch.Tensor, scores: torch.Tensor,
                             classes: torch.Tensor, iou_thr: float,
                             valid: torch.Tensor, max_out: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`aligned_3d_nms`'s plain version, which it runs on the CPU: the
    greedy picks over the whole IoU matrix."""
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
    if _on_card(boxes7):
        return nms3d(boxes7, scores, classes, iou_thr, valid, max_out,
                     rotated=True)
    return rotated_3d_nms_reference(boxes7, scores, classes, iou_thr, valid,
                                    max_out)


def rotated_3d_nms_reference(boxes7: torch.Tensor, scores: torch.Tensor,
                             classes: torch.Tensor, iou_thr: float,
                             valid: torch.Tensor, max_out: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`rotated_3d_nms`'s plain version, which it runs on the CPU: the
    greedy picks over the whole exact IoU matrix."""
    return _greedy_nms(rotated_iou_bev_exact(boxes7, boxes7), scores,
                       classes, iou_thr, valid, max_out)


# -- the kernels of csrc/nms3d.cu ---------------------------------------------

def _on_card(boxes: torch.Tensor) -> bool:
    """Whether the NMS of ``boxes`` runs the kernels: boxes on a CUDA
    device."""
    return boxes.device.type == "cuda"


def _check_boxes(boxes: torch.Tensor, rotated: bool) -> int:
    width = 7 if rotated else 6
    if boxes.ndim != 2 or boxes.shape[1] != width:
        raise ValueError(f"boxes must be (M, {width}), got "
                         f"{tuple(boxes.shape)}")
    if not _on_card(boxes):
        raise ValueError(f"the NMS kernels take boxes on a CUDA device, not "
                         f"on {boxes.device}")
    if boxes.dtype not in _BOX_DTYPES:
        raise ValueError(f"the NMS kernels take float32, float64, bfloat16 "
                         f"or float16 boxes, not {boxes.dtype}")
    m = boxes.shape[0]
    if not 0 < m < 2 ** 31:
        raise ValueError(f"the NMS kernels take 1 to 2**31 - 1 boxes, got {m}")
    return m


def nms3d_mask(boxes: torch.Tensor, classes: torch.Tensor, iou_thr: float,
               rotated: bool) -> torch.Tensor:
    """The suppression mask of `_greedy_nms`, bit-packed: (M, ceil(M /
    64)) int64 words holding uint64 bits, bit b of word w of row i set
    when box i suppresses box 64 w + b (the same class and an IoU above
    ``iou_thr``, or i itself).  One launch of `nms3d_mask_kernel`."""
    m = _check_boxes(boxes, rotated)
    if classes.shape != (m,) or classes.device != boxes.device:
        raise ValueError(f"classes must be ({m},) on {boxes.device}")
    boxes = boxes.contiguous()
    classes = classes.to(torch.int64).contiguous()
    mask = torch.empty((m, (m + 63) // 64), dtype=torch.int64,
                       device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _library().nms3d_mask(
            boxes.data_ptr(), _BOX_DTYPES[boxes.dtype], classes.data_ptr(),
            mask.data_ptr(), m, int(rotated), iou_thr,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nms3d_mask kernel launch failed: cudaError {err}")
    return mask


def nms3d_greedy(mask: torch.Tensor, scores: torch.Tensor,
                 valid: torch.Tensor, max_out: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_greedy_nms`'s picks over `nms3d_mask`'s mask, in one block of
    `nms3d_greedy_kernel`; float64 scores are read as they are, any
    other as float32 (exact for float16 and bfloat16)."""
    m = mask.shape[0]
    if scores.shape != (m,) or valid.shape != (m,) \
            or scores.device != mask.device or valid.device != mask.device:
        raise ValueError(f"scores and valid must be ({m},) on {mask.device}")
    f64 = scores.dtype == torch.float64
    scores = scores.to(torch.float64 if f64 else torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    keep_idx = torch.empty(max_out, dtype=torch.int64, device=mask.device)
    keep_mask = torch.empty(max_out, dtype=torch.bool, device=mask.device)
    # the keys' home when they do not fit in the block's shared memory
    scratch = torch.empty(m, dtype=torch.int64, device=mask.device)
    with torch.cuda.device(mask.device):
        err = _library().nms3d_greedy(
            mask.data_ptr(), scores.data_ptr(), int(f64), valid.data_ptr(),
            keep_idx.data_ptr(), keep_mask.data_ptr(), m, max_out,
            scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nms3d_greedy kernel launch failed: "
                           f"cudaError {err}")
    return keep_idx, keep_mask


def nms3d(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
          iou_thr: float, valid: torch.Tensor, max_out: int,
          rotated: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """`aligned_3d_nms` (``rotated`` False, corner boxes (M, 6)) or
    `rotated_3d_nms` (yaw boxes (M, 7)) on the card: the mask, then the
    greedy picks, the same picks as the plain version's.  `nms3d.launches`
    counts its calls (two kernel launches each)."""
    mask = nms3d_mask(boxes, classes, iou_thr, rotated)
    out = nms3d_greedy(mask, scores, valid, max_out)
    nms3d.launches += 1
    return out


nms3d.launches = 0


def nms3d_iou(boxes: torch.Tensor, rotated: bool) -> torch.Tensor:
    """The (M, M) IoU that `nms3d_mask` thresholds, in the boxes' dtype,
    every pair computed: `aligned_iou_3d(boxes, boxes)` or
    `rotated_iou_bev_exact`, as the kernel computes it (for the tests)."""
    m = _check_boxes(boxes, rotated)
    boxes = boxes.contiguous()
    out = torch.empty((m, m), dtype=boxes.dtype, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _library().nms3d_iou(boxes.data_ptr(), _BOX_DTYPES[boxes.dtype],
                                   out.data_ptr(), m, int(rotated),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nms3d_iou kernel launch failed: cudaError {err}")
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/nms3d.cu`, its entry points typed."""
    lib = build.load("nms3d")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nms3d_mask.argtypes = [ptr, i32, ptr, ptr, i32, i32, ctypes.c_double,
                               ptr]
    lib.nms3d_iou.argtypes = [ptr, i32, ptr, i32, i32, ptr]
    lib.nms3d_greedy.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i32, i32, ptr,
                                 ptr]
    for fn in (lib.nms3d_mask, lib.nms3d_iou, lib.nms3d_greedy):
        fn.restype = ctypes.c_int
    return lib
