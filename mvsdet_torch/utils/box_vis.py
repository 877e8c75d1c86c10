"""Projected 3D-box overlays on source images.

The reference dumps box visualisations at predict time (`visualize_bbox`,
ref: projects/NeRF-Det/nerfdet/mvsdet.py:976-982, backed by the
Det3DLocalVisualizer).  Host-side numpy equivalent: project each box's 8
corners through K[R|t] into a view and draw the 12 wireframe edges.

A copy of mvsdet_tpu/utils/box_vis.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# corner index pairs forming the box wireframe (corners ordered by the
# sign pattern (sx, sy, sz) in {-,+}^3, sz fastest)
_EDGES = (
    (0, 1), (2, 3), (4, 5), (6, 7),      # z edges
    (0, 2), (1, 3), (4, 6), (5, 7),      # y edges
    (0, 4), (1, 5), (2, 6), (3, 7),      # x edges
)


def box_corners(boxes: np.ndarray) -> np.ndarray:
    """World corners of (M, 6) center-size or (M, 7) yaw boxes -> (M, 8, 3)."""
    boxes = np.asarray(boxes, np.float64)
    m = len(boxes)
    signs = np.array([[sx, sy, sz]
                      for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                     np.float64)                              # (8, 3)
    local = signs[None] * (boxes[:, None, 3:6] / 2.0)         # (M, 8, 3)
    if boxes.shape[1] >= 7:
        yaw = boxes[:, 6]
        c, s = np.cos(yaw), np.sin(yaw)
        x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
        y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
        local = np.stack([x, y, local[..., 2]], -1)
    return local + boxes[:, None, :3]


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Clipped line draw by dense sampling (host-side debug dump; speed
    is irrelevant next to the device predict)."""
    h, w = img.shape[:2]
    # cap the sample count: a corner barely past the near-plane cull can
    # project to coords of order 1e6+, and an uncapped n would allocate
    # arrays of that length per edge — 4*max(h,w) covers every on-screen
    # segment at sub-pixel steps
    n = int(min(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1),
                2 * max(h, w))) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(p0[0] + (p1[0] - p0[0]) * ts).astype(np.int64)
    ys = np.round(p0[1] + (p1[1] - p0[1]) * ts).astype(np.int64)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_boxes_on_image(image: np.ndarray, boxes: np.ndarray,
                        w2c: np.ndarray, intrinsic: np.ndarray,
                        color: Tuple[float, float, float],
                        scores: Optional[np.ndarray] = None,
                        score_thr: float = 0.0) -> np.ndarray:
    """Overlay projected 3D box wireframes on one view.

    Args:
      image: (H, W, 3) float [0, 1] or uint8 — copied, not mutated.
      boxes: (M, 6) gravity-centred aligned or (M, 7) yaw boxes.
      w2c: (4, 4) world-to-camera extrinsic of the view.
      intrinsic: (3, 3) or (4, 4) K at the image resolution.
      color: RGB in the image's value range.
      scores: optional (M,) — boxes below ``score_thr`` are skipped.

    Returns:
      the annotated copy of ``image``.
    """
    out = np.array(image, copy=True)
    boxes = np.asarray(boxes)
    if boxes.size == 0:
        return out
    if scores is not None:
        keep = np.asarray(scores) >= score_thr
        boxes = boxes[keep]
        if boxes.size == 0:
            return out
    k = np.asarray(intrinsic, np.float64)[:3, :3]
    rt = np.asarray(w2c, np.float64)[:3, :4]
    corners = box_corners(boxes)                              # (M, 8, 3)
    homo = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    cam = np.einsum("ij,mcj->mci", rt, homo)                  # (M, 8, 3)
    pix = np.einsum("ij,mcj->mci", k, cam)
    z = pix[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = pix[..., :2] / z[..., None]
    color = np.asarray(color, out.dtype)
    for mi in range(len(boxes)):
        for a, b in _EDGES:
            # skip edges with an endpoint behind the camera
            if z[mi, a] <= 1e-6 or z[mi, b] <= 1e-6:
                continue
            _draw_line(out, uv[mi, a], uv[mi, b], color)
    return out


def overlay_detections(image: np.ndarray, w2c: np.ndarray,
                       intrinsic: np.ndarray,
                       pred_boxes: np.ndarray,
                       pred_scores: Optional[np.ndarray] = None,
                       gt_boxes: Optional[np.ndarray] = None,
                       score_thr: float = 0.3) -> np.ndarray:
    """Predictions (green) + GT (red) wireframes on one source view."""
    hi = 1.0 if np.issubdtype(np.asarray(image).dtype, np.floating) else 255
    out = draw_boxes_on_image(image, pred_boxes, w2c, intrinsic,
                              (0.0, hi, 0.0), scores=pred_scores,
                              score_thr=score_thr)
    if gt_boxes is not None and len(gt_boxes):
        out = draw_boxes_on_image(out, gt_boxes, w2c, intrinsic,
                                  (hi, 0.0, 0.0))
    return out
