"""Indoor detection mAP/mAR (host-side numpy).

A copy of mvsdet_tpu/evaluation/indoor_eval.py, so the port imports nothing
of the JAX package.

Re-implementation of the reference evaluation protocol
(mmdet3d/evaluation/functional/indoor_eval.py:8-302): per class, greedy
confidence-ordered matching of detections to GT (axis-aligned 3D IoU),
TP if best IoU > threshold and GT unmatched; AP by the area-under-PR
rule with the same 0/1 padding.  Pure numpy (the reference is CPU numpy
at this stage too, SURVEY §3.3).

Boxes are (cx, cy, cz, dx, dy, dz) gravity-centred axis-aligned, or
(cx, cy, cz, dx, dy, dz, yaw) for ARKit rotated boxes — `indoor_map`
dispatches on the last dimension.  Rotated overlap is exact BEV
Sutherland-Hodgman polygon clipping x z-extent intersection, matching
the mmcv polygon-clip semantics behind the reference's rotated eval
(mmdet3d/evaluation/functional/indoor_eval.py:8-302 with
`DepthInstance3DBoxes.overlaps` -> CUDA `iou3d`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def aligned_iou_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 6) x (N, 6) center-format axis-aligned 3D IoU."""
    a_lo, a_hi = a[:, :3] - a[:, 3:] / 2, a[:, :3] + a[:, 3:] / 2
    b_lo, b_hi = b[:, :3] - b[:, 3:] / 2, b[:, :3] + b[:, 3:] / 2
    lt = np.maximum(a_lo[:, None], b_lo[None])
    rb = np.minimum(a_hi[:, None], b_hi[None])
    whd = np.clip(rb - lt, 0, None)
    inter = whd.prod(-1)
    va = np.clip(a[:, 3:], 0, None).prod(-1)
    vb = np.clip(b[:, 3:], 0, None).prod(-1)
    return inter / np.maximum(va[:, None] + vb[None] - inter, 1e-12)


def _bev_corners(boxes7: np.ndarray) -> np.ndarray:
    """BEV corners of (cx, cy, cz, dx, dy, dz, yaw) boxes -> (M, 4, 2)."""
    cx, cy, dx, dy, yaw = (boxes7[:, 0], boxes7[:, 1], boxes7[:, 3],
                           boxes7[:, 4], boxes7[:, 6])
    cos, sin = np.cos(yaw), np.sin(yaw)
    hx, hy = dx / 2, dy / 2
    local = np.stack([np.stack([hx, hy], -1), np.stack([-hx, hy], -1),
                      np.stack([-hx, -hy], -1), np.stack([hx, -hy], -1)],
                     axis=1)                                   # (M, 4, 2)
    rot = np.stack([np.stack([cos, -sin], -1),
                    np.stack([sin, cos], -1)], axis=1)         # (M, 2, 2)
    pts = np.einsum("mij,mkj->mki", rot, local)
    return pts + np.stack([cx, cy], -1)[:, None, :]


def _clip_polygon(poly: List[np.ndarray], p0: np.ndarray,
                  p1: np.ndarray) -> List[np.ndarray]:
    """Sutherland-Hodgman: keep the half-plane left of edge p0->p1
    (edges wind counter-clockwise for positive-area quads)."""
    edge = p1 - p0
    out: List[np.ndarray] = []
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        c_in = edge[0] * (cur[1] - p0[1]) - edge[1] * (cur[0] - p0[0]) >= 0
        n_in = edge[0] * (nxt[1] - p0[1]) - edge[1] * (nxt[0] - p0[0]) >= 0
        if c_in:
            out.append(cur)
        if c_in != n_in:
            d = nxt - cur
            denom = edge[0] * d[1] - edge[1] * d[0]
            if abs(denom) > 1e-12:
                t = (edge[0] * (p0[1] - cur[1])
                     - edge[1] * (p0[0] - cur[0])) / denom
                out.append(cur + t * d)
    return out


def _poly_area(poly: List[np.ndarray]) -> float:
    if len(poly) < 3:
        return 0.0
    pts = np.stack(poly)
    x, y = pts[:, 0], pts[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2.0)


def rotated_iou_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 7) x (N, 7) exact rotated 3D IoU (BEV polygon clip x z overlap).

    CCW corner winding from `_bev_corners` makes the half-plane test in
    `_clip_polygon` keep the interior; yaw convention matches
    `rotated_iou_bev_sampled` (ops/nms.py:100-169) and the ARKit head
    decode (models/head.py), i.e. the reference's DepthInstance3DBoxes.
    """
    m, n = len(a), len(b)
    iou = np.zeros((m, n), np.float32)
    if m == 0 or n == 0:
        return iou
    ca, cb = _bev_corners(a), _bev_corners(b)
    va = np.clip(a[:, 3:6], 0, None).prod(-1)
    vb = np.clip(b[:, 3:6], 0, None).prod(-1)
    az = np.stack([a[:, 2] - a[:, 5] / 2, a[:, 2] + a[:, 5] / 2], -1)
    bz = np.stack([b[:, 2] - b[:, 5] / 2, b[:, 2] + b[:, 5] / 2], -1)
    # BEV circumscribed-circle pre-filter: pairs whose centre distance
    # exceeds the sum of half-diagonals cannot overlap — skip the O(1)
    # but python-slow polygon clip for them (the common case at eval
    # scale, max_detections x GT x classes x scenes pairs).
    half_diag_a = 0.5 * np.hypot(a[:, 3], a[:, 4])
    half_diag_b = 0.5 * np.hypot(b[:, 3], b[:, 4])
    center_dist = np.hypot(a[:, None, 0] - b[None, :, 0],
                           a[:, None, 1] - b[None, :, 1])
    may_overlap = center_dist <= half_diag_a[:, None] + half_diag_b[None, :]
    for i in range(m):
        for j in range(n):
            if not may_overlap[i, j]:
                continue
            zint = min(az[i, 1], bz[j, 1]) - max(az[i, 0], bz[j, 0])
            if zint <= 0:
                continue
            poly = list(ca[i])
            for k in range(4):
                poly = _clip_polygon(poly, cb[j, k], cb[j, (k + 1) % 4])
                if len(poly) < 3:
                    break
            inter = _poly_area(poly) * zint
            union = va[i] + vb[j] - inter
            if union > 1e-12:
                iou[i, j] = inter / union
    return iou


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Dispatch on box dim: 6 -> axis-aligned, 7 -> rotated."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape[-1] == 7 or b.shape[-1] == 7:
        if a.shape[-1] == 6:
            a = np.concatenate([a, np.zeros((len(a), 1), np.float32)], -1)
        if b.shape[-1] == 6:
            b = np.concatenate([b, np.zeros((len(b), 1), np.float32)], -1)
        return rotated_iou_numpy(a, b)
    return aligned_iou_numpy(a, b)


def _average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area-mode AP with the reference's padding (indoor_eval.py:32-42)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def indoor_map(predictions: Sequence[Dict], ground_truths: Sequence[Dict],
               iou_thresholds: Sequence[float] = (0.25, 0.5),
               num_classes: int = 18) -> Dict[str, float]:
    """Compute mAP/mAR over scenes.

    Args:
      predictions: per scene {boxes (M, 6), scores (M,), labels (M,)}.
      ground_truths: per scene {boxes (B, 6), labels (B,)}.
      iou_thresholds: thresholds, e.g. (0.25, 0.5).
      num_classes: class count (classes absent from all GT are skipped,
        matching eval_map_recall which iterates gt keys).

    Returns:
      {"mAP_0.25": ..., "mAP_0.50": ..., "mAR_...": ...,
       "AP_<cls>_<thr>": ...}.
    """
    results: Dict[str, float] = {}
    present = sorted({int(l) for g in ground_truths for l in g["labels"]})
    aps = {t: [] for t in iou_thresholds}
    ars = {t: [] for t in iou_thresholds}
    for cls in present:
        # gather per-scene class-filtered boxes
        npos = 0
        dets = []  # (score, scene_id, det_idx)
        scene_gt = []
        scene_iou = []
        for sid, (p, g) in enumerate(zip(predictions, ground_truths)):
            gmask = np.asarray(g["labels"]) == cls
            gboxes = np.asarray(g["boxes"], np.float32)[gmask]
            npos += len(gboxes)
            pmask = np.asarray(p["labels"]) == cls
            pboxes = np.asarray(p["boxes"], np.float32)[pmask]
            pscores = np.asarray(p["scores"], np.float32)[pmask]
            iou = (box_iou(pboxes, gboxes)
                   if len(pboxes) and len(gboxes)
                   else np.zeros((len(pboxes), len(gboxes)), np.float32))
            scene_gt.append(len(gboxes))
            scene_iou.append(iou)
            for di, s in enumerate(pscores):
                dets.append((float(s), sid, di))
        if npos == 0:
            continue
        dets.sort(key=lambda t: -t[0])
        for thr in iou_thresholds:
            matched = [np.zeros(n, bool) for n in scene_gt]
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for d, (_, sid, di) in enumerate(dets):
                iou = scene_iou[sid]
                if iou.shape[1] == 0:
                    fp[d] = 1
                    continue
                j = int(np.argmax(iou[di]))
                if iou[di, j] > thr and not matched[sid][j]:
                    tp[d] = 1
                    matched[sid][j] = True
                else:
                    fp[d] = 1
            tp_c = np.cumsum(tp)
            fp_c = np.cumsum(fp)
            recall = tp_c / npos
            precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
            ap = _average_precision(recall, precision)
            aps[thr].append(ap)
            ars[thr].append(float(recall[-1]) if len(recall) else 0.0)
            results[f"AP_{cls}_{thr:.2f}"] = ap
    for thr in iou_thresholds:
        results[f"mAP_{thr:.2f}"] = float(np.mean(aps[thr])) if aps[thr] else 0.0
        results[f"mAR_{thr:.2f}"] = float(np.mean(ars[thr])) if ars[thr] else 0.0
    return results
