"""Anchor-free 3D detection head: convs, targets, losses and prediction.

Port of mvsdet_tpu/models/head.py (reference: `NerfDetHead`,
nerfdet_head.py:90-118, 206-257, 333-562), for axis-aligned boxes and,
with ``with_yaw``, the ARKit head's yaw boxes (`ImVoxelHead_ARKit`,
:634-1243).  Fixed shapes throughout: GT boxes are padded to `max_boxes`
with a mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mvsdet_torch.config import HeadConfig
from mvsdet_torch.models.layers import Conv3d, at_least, sigmoid, softplus
from mvsdet_torch.parallel.collectives import pmean
from mvsdet_torch.ops.nms import (aligned_3d_nms, corner_to_center,
                                  rotated_3d_nms, rotated_iou_3d_soft_pairs)
from mvsdet_torch.utils.profiling import span


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(1, C, nx, ny, nz) -> (nx*ny*nz, C), the JAX channels-last order."""
    return t[0].permute(1, 2, 3, 0).reshape(-1, t.shape[1])


class DetectionHead(nn.Module):
    """Shared-weight per-level conv towers (nerfdet_head.py:90-118).

    Input: levels (1, C, nx, ny, nz).  Output per level: center (V, 1)
    logits, bbox (V, n_reg) distances (exp of the per-level scaled
    output; with ``with_yaw`` the first six, the yaw channel left linear,
    nerfdet_head.py:687-691), cls (V, n_classes) logits.  center and cls
    come out in the compute ``dtype``, bbox in float32: the float32
    per-level scale promotes the JAX module's product
    (mvsdet_tpu/models/head.py:65-68), where torch would keep a 0-dim
    scale's product in bf16 (ROADMAP trap T16).  JAX's yaw channel stays
    in the compute dtype until the concatenation promotes it; cast first,
    it has the same values.
    """

    def __init__(self, cfg: HeadConfig, in_channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.with_yaw = cfg.with_yaw
        self.conv_center = Conv3d(in_channels, 1, 3, padding=1, bias=False,
                                  dtype=dtype)
        self.conv_reg = Conv3d(in_channels, cfg.n_reg_outs, 3, padding=1,
                               bias=False, dtype=dtype)
        self.conv_cls = Conv3d(in_channels, cfg.n_classes, 3, padding=1,
                               dtype=dtype)
        self.scales = nn.Parameter(torch.ones(cfg.n_levels))

    def forward(self, levels: Sequence[torch.Tensor]):
        outs = []
        for i, x in enumerate(levels):
            center = _flat(self.conv_center(x))
            reg = self.conv_reg(x).to(self.scales.dtype)
            if self.with_yaw:
                reg = torch.cat([torch.exp(self.scales[i] * reg[:, :6]),
                                 reg[:, 6:]], dim=1)
            else:
                reg = torch.exp(self.scales[i] * reg)
            reg = _flat(reg)
            cls = _flat(self.conv_cls(x))
            outs.append((center, reg, cls))
        return outs


FLOAT_MAX = 1e8


def face_distances(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(P, 3) points, (B, 6) centre-size boxes -> (P, B, 6) distances to
    the faces (x_min, x_max, y_min, y_max, z_min, z_max) (:433-452)."""
    p = points[:, None, :]
    c = boxes[None, :, :3]
    h = boxes[None, :, 3:6] / 2.0
    lo = p - (c - h)
    hi = (c + h) - p
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
                        lo[..., 2], hi[..., 2]], dim=-1)


def centerness_from_faces(fd: torch.Tensor) -> torch.Tensor:
    """FCOS centerness from face distances (:454-471)."""
    ratio = 1.0
    for a in (0, 2, 4):
        lo = torch.minimum(fd[..., a], fd[..., a + 1])
        hi = torch.maximum(fd[..., a], fd[..., a + 1])
        ratio = ratio * lo / torch.clamp_min(hi, 1e-12)
    return torch.sqrt(torch.clamp_min(ratio, 0.0))


def assign_targets(points: torch.Tensor, scales: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_mask: torch.Tensor, cfg: HeadConfig):
    """FCOS-3D targets with fixed shapes (`_get_targets`, :473-562): inside
    the box; at the box's best level (the last level before the one where
    it holds fewer than `pts_assign_threshold` points); among the top
    `pts_center_threshold` by centerness; ties to the smallest box, the
    first on equal volumes (argmin's first index, as in JAX).

    Args:
      points: (P, 3) all levels' points; scales: (P,) level of each;
      gt_boxes: (B, 6); gt_labels: (B,); gt_mask: (B,) bool.

    Returns:
      centerness_t (P,), bbox_t (P, 6) corner boxes, labels_t (P,) with
      -1 for background.
    """
    n_levels = cfg.n_levels
    p_cnt = points.shape[0]
    fd = face_distances(points, gt_boxes)                     # (P, B, 6)
    inside = (fd.amin(dim=-1) > 0) & gt_mask[None, :]         # (P, B)

    levels = torch.arange(n_levels, device=points.device)
    scale_onehot = (scales[:, None] == levels[None, :]).to(torch.float32)
    n_pos_per_scale = scale_onehot.T @ inside.to(torch.float32)   # (L, B)
    lower = n_pos_per_scale < cfg.pts_assign_threshold
    extra = torch.arange(n_levels, 0, -1, device=points.device)[:, None]
    lower_index = torch.clamp_min(
        torch.argmax(lower.to(torch.int64) * extra, dim=0) - 1, 0)
    all_upper = (~lower).all(dim=0)
    best_scale = torch.where(all_upper, n_levels - 1, lower_index)
    inside_best = best_scale[None, :] == scales[:, None]      # (P, B)

    cness = centerness_from_faces(fd)                         # (P, B)
    cness_m = torch.where(inside & inside_best, cness, -1.0)
    k = min(cfg.pts_center_threshold + 1, p_cnt)
    thresh = torch.topk(cness_m.T, k, dim=1).values[:, -1]    # (B,)
    inside_top = cness_m > thresh[None, :]

    volumes = torch.clamp_min(gt_boxes[:, 3:6], 0.0).prod(dim=-1)
    vol = torch.where(inside & inside_best & inside_top,
                      volumes[None, :].expand(p_cnt, -1), FLOAT_MAX)
    min_vol = vol.amin(dim=1)
    min_inds = torch.argmin(vol, dim=1)                       # first index
    labels_t = torch.where(min_vol >= FLOAT_MAX, -1,
                           gt_labels[min_inds].to(torch.int64))
    fd_sel = fd[torch.arange(p_cnt, device=points.device), min_inds]
    return centerness_from_faces(fd_sel), decode_bbox(points, fd_sel), \
        labels_t


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       gamma: float, alpha: float) -> torch.Tensor:
    """(P, C) logits, (P,) labels (-1 = background) -> (P,) focal loss
    summed over classes (mmdet FocalLoss).  The one-hot is a comparison
    with arange(C), so -1 gives zeros as `jax.nn.one_hot` does."""
    c = logits.shape[-1]
    y = (labels[:, None] == torch.arange(c, device=labels.device)[None, :]) \
        .to(logits.dtype)
    p = sigmoid(logits)
    ce = softplus(-logits) * y + softplus(logits) * (1 - y)
    p_t = p * y + (1 - p) * (1 - y)
    alpha_t = alpha * y + (1 - alpha) * (1 - y)
    return (alpha_t * (1 - p_t) ** gamma * ce).sum(dim=-1)


def axis_aligned_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of corner boxes (iou3d_calculator.py:180)."""
    lt = torch.maximum(pred[..., :3], target[..., :3])
    rb = torch.minimum(pred[..., 3:], target[..., 3:])
    inter = torch.clamp_min(rb - lt, 0.0).prod(dim=-1)
    v1 = torch.clamp_min(pred[..., 3:] - pred[..., :3], 0.0).prod(dim=-1)
    v2 = torch.clamp_min(target[..., 3:] - target[..., :3], 0.0).prod(dim=-1)
    return inter / torch.clamp_min(v1 + v2 - inter, 1e-12)


def head_loss(head_outs, points_per_level: List[torch.Tensor],
              valid_per_level: List[torch.Tensor], gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_mask: torch.Tensor,
              cfg: HeadConfig, n_pos_override: Optional[torch.Tensor] = None,
              data_group=None):
    """Single-scene head loss (`_loss_by_feat_single`, :206-257): focal
    classification over valid points, centerness BCE and centerness-
    weighted (1 - IoU) over positives.

    The focal and centerness terms divide by the positive count: this
    scene's, or with ``data_group`` its mean over the group's scenes (the
    reference's DDP `reduce_mean`, mvsdet_tpu/models/head.py:245-248), or
    ``n_pos_override`` where given; at least 1.

    Returns:
      dict(center_loss, bbox_loss, cls_loss), dict(n_pos=local count).
    """
    center, reg, cls, valid, points, scales = _concat_levels(
        head_outs, points_per_level, valid_per_level)
    cness_t, bbox_t, labels_t = assign_targets(points, scales, gt_boxes,
                                               gt_labels, gt_mask, cfg)
    per_point = 1.0 - axis_aligned_iou(decode_bbox(points, reg), bbox_t)
    return _losses(center, cls, valid, cness_t, labels_t, per_point, cfg,
                   n_pos_override, data_group)


def _concat_levels(head_outs, points_per_level, valid_per_level):
    """All levels' center (P,), reg (P, n_reg), cls (P, C), valid (P,),
    points (P, 3) and level index (P,)."""
    center = torch.cat([o[0][:, 0] for o in head_outs])
    reg = torch.cat([o[1] for o in head_outs])
    cls = torch.cat([o[2] for o in head_outs])
    scales = torch.cat([torch.full((p.shape[0],), i, dtype=torch.int64,
                                   device=p.device)
                        for i, p in enumerate(points_per_level)])
    return (center, reg, cls, torch.cat(valid_per_level),
            torch.cat(points_per_level), scales)


def _losses(center, cls, valid, cness_t, labels_t, per_point,
            cfg: HeadConfig, n_pos_override=None, data_group=None):
    """The three weighted terms from the targets and the per-point box
    loss: focal over valid points, centerness BCE over positives, the box
    loss weighted by the centerness target.  The positive count is
    ``n_pos_override``, else this scene's, averaged over ``data_group``
    where one is given."""
    pos = (labels_t >= 0) & valid
    n_pos_local = pos.to(torch.float32).sum()
    if n_pos_override is not None:
        n_pos = torch.as_tensor(n_pos_override, dtype=torch.float32,
                                device=n_pos_local.device)
    elif data_group is not None:
        n_pos = pmean(n_pos_local, data_group)
    else:
        n_pos = n_pos_local
    n_pos = torch.clamp_min(n_pos, 1.0)

    cls_labels = torch.where(valid, labels_t, -1)
    focal = sigmoid_focal_loss(cls, cls_labels, cfg.focal_gamma,
                               cfg.focal_alpha)
    # in bf16 the focal sum is rounded to bf16, as jnp.sum leaves it,
    # before the float32 count promotes it
    cls_loss = torch.where(valid, focal, 0.0).sum().to(n_pos.dtype) / n_pos

    bce = softplus(-center) * cness_t + softplus(center) * (1 - cness_t)
    center_loss = torch.where(pos, bce, 0.0).sum() / n_pos

    w = torch.where(pos, cness_t, 0.0)
    bbox_loss = (per_point * w).sum() / torch.clamp_min(w.sum(), 1e-6)

    losses = dict(center_loss=center_loss * cfg.center_loss_weight,
                  bbox_loss=bbox_loss * cfg.bbox_loss_weight,
                  cls_loss=cls_loss * cfg.cls_loss_weight)
    return losses, dict(n_pos=n_pos_local)


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

    Per level: score = sigmoid(cls) * sigmoid(center) * valid, in the
    head's compute dtype, the top `nms_pre` by max score, decode; then
    class-aware greedy NMS.  The top `nms_pre` are taken as JAX's top_k
    takes them, the lower index first among equal scores, by a stable
    descending sort: invalid voxels all score 0 (ROADMAP trap T9), and
    bf16 scores tie often at nonzero values (T15), where `torch.topk`
    promises no order.

    Returns:
      boxes (max_det, 6) centre format, scores and labels (max_det,),
      mask (max_det,) bool.
    """
    boxes, best_score, labels = _candidates(
        head_outs, points_per_level, valid_per_level, cfg, decode_bbox)
    with span("mvsdet.nms"):
        keep_idx, keep_mask = aligned_3d_nms(
            boxes, best_score, labels, cfg.iou_thr,
            best_score > cfg.score_thr, cfg.max_detections)
    return dict(boxes=corner_to_center(boxes[keep_idx]),
                scores=best_score[keep_idx] * keep_mask,
                labels=labels[keep_idx],
                mask=keep_mask)


def _candidates(head_outs, points_per_level, valid_per_level,
                cfg: HeadConfig, decode):
    """Each level's top `nms_pre` points by max score (the stable sort of
    `head_predict`), decoded by ``decode``; all levels' boxes, best
    scores and labels."""
    all_boxes, all_scores = [], []
    for (center, reg, cls), pts, valid in zip(head_outs, points_per_level,
                                              valid_per_level):
        score = (sigmoid(cls) * sigmoid(center)
                 * valid[:, None].to(cls.dtype))
        k = min(cfg.nms_pre, score.shape[0])
        ids = torch.sort(score.amax(dim=1), descending=True,
                         stable=True).indices[:k]
        all_boxes.append(decode(pts[ids], reg[ids]))
        all_scores.append(score[ids])
    best_score, labels = torch.cat(all_scores).max(dim=1)
    return torch.cat(all_boxes), best_score, labels


# -- the ARKit head: yaw boxes (cx, cy, cz, dx, dy, dz, yaw) -----------------

def rotate_z(points: torch.Tensor, angle) -> torch.Tensor:
    """(..., 3) points turned about +z by ``angle`` (broadcast)
    (`rotation_3d_in_axis(..., axis=2)`, nerfdet_head.py:1049, 1074)."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] * c - points[..., 1] * s
    y = points[..., 0] * s + points[..., 1] * c
    return torch.stack([x, y, points[..., 2]], dim=-1)


def decode_bbox_rotated(points: torch.Tensor, pred: torch.Tensor
                        ) -> torch.Tensor:
    """(P, 7) face distances and yaw -> (P, 7) yaw boxes
    (`ImVoxelHead_ARKit._bbox_pred_to_bbox`, :1029-1055)."""
    shift = torch.stack([(pred[:, 1] - pred[:, 0]) / 2,
                         (pred[:, 3] - pred[:, 2]) / 2,
                         (pred[:, 5] - pred[:, 4]) / 2], dim=-1)
    center = points + rotate_z(shift, pred[:, 6])
    size = torch.stack([pred[:, 0] + pred[:, 1], pred[:, 2] + pred[:, 3],
                        pred[:, 4] + pred[:, 5]], dim=-1)
    return torch.cat([center, size, pred[:, 6:7]], dim=-1)


def box7_corners(boxes7: torch.Tensor) -> torch.Tensor:
    """The 8 world-space corners of yaw boxes, (..., 8, 3), x-major then y
    then z over the signs (-1, 1)."""
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=torch.float32,
                         device=boxes7.device)
    local = signs * (boxes7[..., 3:6] / 2.0)[..., None, :]
    return rotate_z(local, boxes7[..., None, 6]) + boxes7[..., None, :3]


def assign_targets_rotated(points: torch.Tensor, scales: torch.Tensor,
                           gt_boxes7: torch.Tensor, gt_labels: torch.Tensor,
                           gt_mask: torch.Tensor, cfg: HeadConfig):
    """FCOS-3D targets for yaw boxes (`ImVoxelHead_ARKit._get_targets`,
    :1107-1185): `assign_targets`'s conditions on face distances taken in
    each box's own frame, with the best level the first level where the
    box holds fewer than `pts_assign_threshold` points, minus one (plain
    argmax here, unlike the aligned head); the targets are the matched
    boxes themselves.

    Returns:
      centerness_t (P,), box_t (P, 7), labels_t (P,) with -1 for
      background.
    """
    n_levels = cfg.n_levels
    p_cnt = points.shape[0]
    centers = gt_boxes7[None, :, :3] + rotate_z(
        points[:, None, :] - gt_boxes7[None, :, :3], -gt_boxes7[None, :, 6])
    h = gt_boxes7[None, :, 3:6] / 2.0
    lo = centers - (gt_boxes7[None, :, :3] - h)
    hi = (gt_boxes7[None, :, :3] + h) - centers
    fd = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
                      lo[..., 2], hi[..., 2]], dim=-1)        # (P, B, 6)
    inside = (fd.amin(dim=-1) > 0) & gt_mask[None, :]

    levels = torch.arange(n_levels, device=points.device)
    scale_onehot = (scales[:, None] == levels[None, :]).to(torch.float32)
    n_pos_per_scale = scale_onehot.T @ inside.to(torch.float32)   # (L, B)
    lower = n_pos_per_scale < cfg.pts_assign_threshold
    lower_index = torch.clamp_min(
        torch.argmax(lower.to(torch.int64), dim=0) - 1, 0)
    all_upper = (~lower).all(dim=0)
    best_scale = torch.where(all_upper, n_levels - 1, lower_index)
    inside_best = best_scale[None, :] == scales[:, None]

    cness_m = torch.where(inside & inside_best, centerness_from_faces(fd),
                          -1.0)
    k = min(cfg.pts_center_threshold + 1, p_cnt)
    thresh = torch.topk(cness_m.T, k, dim=1).values[:, -1]    # (B,)
    inside_top = cness_m > thresh[None, :]

    volumes = torch.clamp_min(gt_boxes7[:, 3:6], 0.0).prod(dim=-1)
    vol = torch.where(inside & inside_best & inside_top,
                      volumes[None, :].expand(p_cnt, -1), FLOAT_MAX)
    min_vol = vol.amin(dim=1)
    min_inds = torch.argmin(vol, dim=1)                       # first index
    labels_t = torch.where(min_vol >= FLOAT_MAX, -1,
                           gt_labels[min_inds].to(torch.int64))
    centerness_t = cness_m[torch.arange(p_cnt, device=points.device),
                           min_inds]
    return centerness_t, gt_boxes7[min_inds], labels_t


def head_loss_rotated(head_outs, points_per_level: List[torch.Tensor],
                      valid_per_level: List[torch.Tensor],
                      gt_boxes7: torch.Tensor, gt_labels: torch.Tensor,
                      gt_mask: torch.Tensor, cfg: HeadConfig,
                      data_group=None):
    """The ARKit head's loss: `head_loss`'s focal and centerness terms and
    a rotated box loss, by `cfg.rotated_bbox_loss`:

      "rotated_iou"  1 - `rotated_iou_3d_soft_pairs` of the decoded box
                     and its target (the reference's RotatedIoU3DLoss);
      "decoupled"    smooth-L1 (beta 1) over the centre error in the
                     target's frame over its size, the log size ratio,
                     and sin / 1 - cos of the yaw difference.

    Both weighted by the centerness target.  With ``data_group`` the
    positive count is averaged over the group's scenes, as `head_loss`'s
    (mvsdet_tpu/models/head.py:395-397).  Returns as `head_loss`.
    """
    center, reg, cls, valid, points, scales = _concat_levels(
        head_outs, points_per_level, valid_per_level)
    cness_t, box_t, labels_t = assign_targets_rotated(
        points, scales, gt_boxes7, gt_labels, gt_mask, cfg)
    pred7 = decode_bbox_rotated(points, reg)
    if cfg.rotated_bbox_loss == "rotated_iou":
        per_point = 1.0 - rotated_iou_3d_soft_pairs(pred7, box_t)
    elif cfg.rotated_bbox_loss == "decoupled":
        size_t = at_least(box_t[:, 3:6], 1e-4)
        d_center = rotate_z(pred7[:, :3] - box_t[:, :3], -box_t[:, 6]) \
            / size_t
        e_size = torch.log(at_least(pred7[:, 3:6], 1e-4) / size_t)
        dyaw = pred7[:, 6] - box_t[:, 6]
        e_yaw = torch.stack([torch.sin(dyaw), 1.0 - torch.cos(dyaw)], dim=-1)
        dist = torch.cat([d_center, e_size, e_yaw], dim=-1).abs()  # (P, 8)
        per_point = torch.where(dist < 1.0, 0.5 * dist ** 2,
                                dist - 0.5).mean(dim=-1)
    else:
        raise ValueError(
            f"unknown rotated_bbox_loss {cfg.rotated_bbox_loss!r}")
    return _losses(center, cls, valid, cness_t, labels_t, per_point, cfg,
                   data_group=data_group)


def head_predict_rotated(head_outs, points_per_level: List[torch.Tensor],
                         valid_per_level: List[torch.Tensor],
                         cfg: HeadConfig) -> Dict[str, torch.Tensor]:
    """The ARKit head's prediction: `head_predict` with yaw boxes decoded
    by `decode_bbox_rotated` and the exact rotated NMS
    (`_single_scene_multiclass_nms` + `nms3d`, :1190-1243).

    Returns:
      boxes (max_det, 7), scores and labels (max_det,), mask (max_det,).
    """
    boxes, best_score, labels = _candidates(
        head_outs, points_per_level, valid_per_level, cfg,
        decode_bbox_rotated)
    with span("mvsdet.nms"):
        keep_idx, keep_mask = rotated_3d_nms(
            boxes, best_score, labels, cfg.iou_thr,
            best_score > cfg.score_thr, cfg.max_detections)
    return dict(boxes=boxes[keep_idx],
                scores=best_score[keep_idx] * keep_mask,
                labels=labels[keep_idx],
                mask=keep_mask)
