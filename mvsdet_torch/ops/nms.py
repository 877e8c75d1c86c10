"""Axis-aligned 3D non-maximum suppression (port of the aligned path of
mvsdet_tpu/ops/nms.py; reference: nerfdet_head.py:573-629).

Greedy and class-aware, with a static number of picks so that the loop
never waits on the device: each pick takes the highest active score and
suppresses the same-class boxes it overlaps above the threshold.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
    m = boxes.shape[0]
    dev = boxes.device
    suppress = ((aligned_iou_3d(boxes, boxes) > iou_thr)
                & (classes[:, None] == classes[None, :]))
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


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(x1..z2) corners -> (cx, cy, cz, w, l, h) (nerfdet_head.py:573-578)."""
    center = (boxes[..., :3] + boxes[..., 3:]) / 2.0
    size = boxes[..., 3:] - boxes[..., :3]
    return torch.cat([center, size], dim=-1)
