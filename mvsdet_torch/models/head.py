"""Anchor-free 3D detection head: convs, decode and prediction.

Port of the predict path of mvsdet_tpu/models/head.py (reference:
`NerfDetHead`, nerfdet_head.py:90-118, 333-427).  Target assignment and
the losses come with the training slice; the rotated ARKit head later.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from mvsdet_torch.config import HeadConfig
from mvsdet_torch.ops.nms import aligned_3d_nms, corner_to_center


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(1, C, nx, ny, nz) -> (nx*ny*nz, C), the JAX channels-last order."""
    return t[0].permute(1, 2, 3, 0).reshape(-1, t.shape[1])


class DetectionHead(nn.Module):
    """Shared-weight per-level conv towers (nerfdet_head.py:90-118).

    Input: levels (1, C, nx, ny, nz).  Output per level: center (V, 1)
    logits, bbox (V, n_reg) distances (exp of the per-level scaled
    output), cls (V, n_classes) logits.
    """

    def __init__(self, cfg: HeadConfig, in_channels: int = 128):
        super().__init__()
        if cfg.with_yaw:
            raise NotImplementedError("the rotated (ARKit) head is not "
                                      "ported yet")
        self.conv_center = nn.Conv3d(in_channels, 1, 3, padding=1, bias=False)
        self.conv_reg = nn.Conv3d(in_channels, cfg.n_reg_outs, 3, padding=1,
                                  bias=False)
        self.conv_cls = nn.Conv3d(in_channels, cfg.n_classes, 3, padding=1)
        self.scales = nn.Parameter(torch.ones(cfg.n_levels))

    def forward(self, levels: Sequence[torch.Tensor]):
        outs = []
        for i, x in enumerate(levels):
            center = _flat(self.conv_center(x))
            reg = _flat(torch.exp(self.scales[i] * self.conv_reg(x)))
            cls = _flat(self.conv_cls(x))
            outs.append((center, reg, cls))
        return outs


def decode_bbox(points: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Face distances -> corner boxes (`_bbox_pred_to_bbox`, :422-427)."""
    return torch.stack([
        points[:, 0] - pred[:, 0], points[:, 1] - pred[:, 2],
        points[:, 2] - pred[:, 4], points[:, 0] + pred[:, 1],
        points[:, 1] + pred[:, 3], points[:, 2] + pred[:, 5],
    ], dim=-1)


def head_predict(head_outs, points_per_level: List[torch.Tensor],
                 valid_per_level: List[torch.Tensor],
                 cfg: HeadConfig) -> Dict[str, torch.Tensor]:
    """Single-scene box prediction (`_predict_by_feat_single`, :333-390).

    Per level: score = sigmoid(cls) * sigmoid(center) * valid, the top
    `nms_pre` by max score, decode; then class-aware greedy NMS.
    Invalid voxels all score 0, and `torch.topk` orders ties otherwise
    than JAX's top_k (ROADMAP trap T9): such boxes sit below `score_thr`
    and are masked, and padded slots index box 0, so outputs agree with
    the JAX package under `mask`.

    Returns:
      boxes (max_det, 6) centre format, scores and labels (max_det,),
      mask (max_det,) bool.
    """
    all_boxes, all_scores = [], []
    for (center, reg, cls), pts, valid in zip(head_outs, points_per_level,
                                              valid_per_level):
        score = (torch.sigmoid(cls) * torch.sigmoid(center)
                 * valid[:, None].to(cls.dtype))
        k = min(cfg.nms_pre, score.shape[0])
        ids = torch.topk(score.amax(dim=1), k).indices
        all_boxes.append(decode_bbox(pts[ids], reg[ids]))
        all_scores.append(score[ids])
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)

    best_score, labels = scores.max(dim=1)
    keep_idx, keep_mask = aligned_3d_nms(
        boxes, best_score, labels, cfg.iou_thr, best_score > cfg.score_thr,
        cfg.max_detections)
    return dict(boxes=corner_to_center(boxes[keep_idx]),
                scores=best_score[keep_idx] * keep_mask,
                labels=labels[keep_idx],
                mask=keep_mask)
