"""Synthetic multi-view scenes with exact geometric ground truth.

A copy of mvsdet_tpu/data/synthetic.py, so the port imports nothing of the
JAX package.

Fills the role of the miniature fixtures under the reference's
`tests/data/scannet/` (SURVEY §4) — but generated, with full control:
posed cameras on a ring, coloured spheres as scene content (cheap exact
ray casting for RGB + depth), and their bounding boxes as detection GT.
Used by unit/e2e tests, the overfit smoke test, and `bench.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from mvsdet_torch.config import Config

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _render_spheres(c2w, k, hw, centers, radii, colors, bg=0.72):
    """Exact ray-cast RGB + z-depth of opaque spheres (numpy, vectorised)."""
    h, w = hw
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    dirs_cam = np.stack([(xs - k[0, 2]) / k[0, 0],
                         (ys - k[1, 2]) / k[1, 1],
                         np.ones_like(xs)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_n = dirs / norm
    eye = c2w[:3, 3]

    best_t = np.full((h, w), np.inf)
    rgb = np.full((h, w, 3), bg, np.float32)
    for c, r, col in zip(centers, radii, colors):
        oc = eye - c
        b = np.einsum("hwi,i->hw", dirs_n, oc)
        disc = b * b - (oc @ oc - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 0.05) & (t < best_t)
        best_t = np.where(hit, t, best_t)
        # diffuse-ish shading from the surface normal
        p = eye + dirs_n * t[..., None]
        nrm = (p - c) / r
        shade = 0.55 + 0.45 * np.clip(nrm[..., 2], 0, 1)
        rgb = np.where(hit[..., None], np.asarray(col) * shade[..., None],
                       rgb)
    # z-depth (camera-frame z), not ray length
    z = best_t * dirs_cam[..., 2] / np.maximum(norm[..., 0], 1e-9)
    z = np.where(np.isfinite(z), z, 0.0)
    return rgb.astype(np.float32), z.astype(np.float32)


def make_synthetic_scene(cfg: Config, seed: int = 0, n_views: Optional[int] = None,
                         n_targets: Optional[int] = None,
                         arkit: bool = False) -> Dict[str, np.ndarray]:
    """Build a single-scene batch dict for the MVSDet model.

    Returns host numpy arrays with the static shapes the model expects
    (see `MVSDet.extract_feat` docstring).  With ``arkit=True``,
    intrinsics become per-view (N, 4, 4) / per-target (T, 4, 4) and GT
    boxes carry a yaw angle (7-dim), matching the ARKitScenes paths.
    """
    rng = np.random.RandomState(seed)
    mc = cfg.model
    h, w = mc.image_size
    ht, wt = mc.target_size
    n_src = n_views if n_views is not None else cfg.data.n_src_train
    n_tgt = n_targets if n_targets is not None else cfg.data.nerf_target_views_train

    # scene content: spheres inside the voxel AABB
    n_obj = min(4, mc.head.max_boxes)
    centers = rng.uniform(-1.2, 1.2, (n_obj, 3))
    centers[:, 2] = rng.uniform(0.2, 0.9, n_obj)
    radii = rng.uniform(0.25, 0.45, n_obj)
    colors = rng.uniform(0.2, 1.0, (n_obj, 3))
    labels = rng.randint(0, mc.head.n_classes, n_obj)

    # intrinsics at image resolution
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = 0.9 * w
    k[0, 2], k[1, 2] = w / 2.0, h / 2.0
    kt = np.eye(4, dtype=np.float32)
    kt[0, 0] = kt[1, 1] = 0.9 * wt
    kt[0, 2], kt[1, 2] = wt / 2.0, ht / 2.0

    def ring_pose(i, n, jitter):
        ang = 2 * np.pi * i / n
        eye = np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                        1.4 + jitter * rng.randn()])
        return _look_at(eye, [0, 0, 0.5])

    imgs, denorms, depths, w2cs = [], [], [], []
    for i in range(n_src):
        c2w = ring_pose(i, n_src, 0.05)
        rgb, z = _render_spheres(c2w, k, (h, w), centers, radii, colors)
        denorms.append(rgb)
        imgs.append((rgb * 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
        depths.append(z)
        w2cs.append(np.linalg.inv(c2w).astype(np.float32))

    tgt_c2ws, gt_imgs, gt_depths = [], [], []
    for i in range(n_tgt):
        c2w = ring_pose(i + 0.5, n_tgt, 0.02)
        rgb, z = _render_spheres(c2w, kt, (ht, wt), centers, radii, colors)
        tgt_c2ws.append(c2w.astype(np.float32))
        gt_imgs.append(rgb)
        gt_depths.append(z)

    max_b = mc.head.max_boxes
    box_dim = 7 if arkit else 6
    gt_boxes = np.zeros((max_b, box_dim), np.float32)
    gt_labels = np.zeros((max_b,), np.int32)
    gt_mask = np.zeros((max_b,), bool)
    gt_boxes[:n_obj, :3] = centers
    gt_boxes[:n_obj, 3:6] = 2 * radii[:, None]
    if arkit:
        gt_boxes[:n_obj, 6] = rng.uniform(-np.pi, np.pi, n_obj)
    gt_labels[:n_obj] = labels
    gt_mask[:n_obj] = True

    if arkit:
        # per-view intrinsics with small focal jitter (ARKit records a K
        # per frame; mvsdet.py:421-428 / :549-553)
        k = np.stack([k] * n_src)
        k[:, 0, 0] *= 1.0 + 0.01 * rng.randn(n_src)
        k[:, 1, 1] *= 1.0 + 0.01 * rng.randn(n_src)
        kt = np.stack([kt] * n_tgt)

    return dict(
        images=np.stack(imgs).astype(np.float32),
        denorm_images=np.stack(denorms),
        depth=np.stack(depths),
        w2c=np.stack(w2cs),
        intrinsic=k,
        origin=np.array([0.0, 0.0, 0.5], np.float32),
        tgt_c2w=np.stack(tgt_c2ws),
        tgt_intrinsic=kt,
        gt_images=np.stack(gt_imgs),
        gt_depth=np.stack(gt_depths),
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_mask=gt_mask,
    )
