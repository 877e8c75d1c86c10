"""The benchmark's scenes: seeded synthetic multi-view scenes with exact
ground truth.

A frozen copy of mvsdet_torch/data/synthetic.py at commit dafa6b3
(`make_synthetic_scene`), with two changes: the spheres are ray-cast by
torch on the card in float64 rather than by numpy on the host (the host
version takes 1.4 s for a 40-view scene and 2.5 s for 80 views, which
every run would pay in set-up), and a scene's random draws are seeded
from (seed, index) by numpy's `SeedSequence`, which takes any seed.  The
draws, their order and the layout of the returned batch are the copy's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


def _render_spheres(c2ws, ks, hw, centers, radii, colors, device,
                    bg=0.72):
    """Exact ray-cast RGB and z-depth of opaque spheres for a stack of
    views (V, 4, 4) c2w and (V, 4, 4) K, in float64 on ``device``.
    Returns host float32 (V, H, W, 3) and (V, H, W)."""
    f64 = dict(dtype=torch.float64, device=device)
    h, w = hw
    c2w, k = torch.as_tensor(c2ws, **f64), torch.as_tensor(ks, **f64)
    ys, xs = torch.meshgrid(torch.arange(h, **f64) + 0.5,
                            torch.arange(w, **f64) + 0.5, indexing="ij")
    dirs_cam = torch.stack([
        (xs[None] - k[:, 0, 2, None, None]) / k[:, 0, 0, None, None],
        (ys[None] - k[:, 1, 2, None, None]) / k[:, 1, 1, None, None],
        torch.ones_like(xs).expand(k.shape[0], h, w)], -1)   # (V, H, W, 3)
    dirs = torch.einsum("vhwj,vij->vhwi", dirs_cam, c2w[:, :3, :3])
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs / norm
    eye = c2w[:, :3, 3]                                        # (V, 3)

    best_t = torch.full(dirs.shape[:3], torch.inf, **f64)
    rgb = torch.full(dirs.shape[:3] + (3,), bg, **f64)
    for c, r, col in zip(centers, radii, colors):
        c = torch.as_tensor(c, **f64)
        oc = eye - c                                           # (V, 3)
        b = torch.einsum("vhwi,vi->vhw", dirs_n, oc)
        disc = b * b - ((oc * oc).sum(-1) - r * r)[:, None, None]
        hit = disc > 0
        t = -b - torch.sqrt(torch.clamp_min(disc, 0))
        hit &= (t > 0.05) & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        # diffuse-ish shading from the surface normal
        p = eye[:, None, None] + dirs_n * t[..., None]
        nrm = (p - c) / r
        shade = 0.55 + 0.45 * torch.clamp(nrm[..., 2], 0, 1)
        rgb = torch.where(hit[..., None],
                          torch.as_tensor(col, **f64) * shade[..., None], rgb)
    # z-depth (camera-frame z), not ray length
    z = best_t * dirs_cam[..., 2] / torch.clamp_min(norm[..., 0], 1e-9)
    z = torch.where(torch.isfinite(z), z, 0.0)
    return (rgb.to(torch.float32).cpu().numpy(),
            z.to(torch.float32).cpu().numpy())


def scene_seed(seed: int, index: int) -> int:
    """The numpy seed of scene ``index`` of the pool of run ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def make_scene(cfg, seed: int, n_views: int, n_targets: int,
               arkit: bool = False, device="cuda") -> Dict[str, np.ndarray]:
    """One scene batch for MVSDet: host numpy arrays in the layout of
    `make_synthetic_scene` (the copied function), ``n_views`` source views
    and ``n_targets`` render targets; with ``arkit``, per-view (N, 4, 4)
    and per-target (T, 4, 4) intrinsics and 7-dim yaw boxes.  ``cfg`` is
    a `Config` of the port or of the reference (its sizes only)."""
    rng = np.random.RandomState(seed)
    mc = cfg.model
    h, w = mc.image_size
    ht, wt = mc.target_size
    n_src, n_tgt = n_views, n_targets

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

    src_c2ws = [ring_pose(i, n_src, 0.05) for i in range(n_src)]
    tgt_c2ws = [ring_pose(i + 0.5, n_tgt, 0.02) for i in range(n_tgt)]

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

    k_src = np.stack([k] * n_src)
    if arkit:
        # per-view intrinsics with small focal jitter (ARKit records a K
        # per frame)
        k_src[:, 0, 0] *= 1.0 + 0.01 * rng.randn(n_src)
        k_src[:, 1, 1] *= 1.0 + 0.01 * rng.randn(n_src)
    # the copied function renders every view with the shared K; its
    # jittered K is what the model is told
    denorm, depth = _render_spheres(np.stack(src_c2ws), np.stack([k] * n_src),
                                    (h, w), centers, radii, colors, device)
    gt_imgs, gt_depth = _render_spheres(np.stack(tgt_c2ws),
                                        np.stack([kt] * n_tgt), (ht, wt),
                                        centers, radii, colors, device)
    return dict(
        images=((denorm * 255.0 - IMAGENET_MEAN) / IMAGENET_STD
                ).astype(np.float32),
        denorm_images=denorm,
        depth=depth,
        w2c=np.linalg.inv(np.stack(src_c2ws)).astype(np.float32),
        intrinsic=k_src if arkit else k,
        origin=np.array([0.0, 0.0, 0.5], np.float32),
        tgt_c2w=np.stack(tgt_c2ws).astype(np.float32),
        tgt_intrinsic=np.stack([kt] * n_tgt) if arkit else kt,
        gt_images=gt_imgs,
        gt_depth=gt_depth,
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_mask=gt_mask,
    )


def make_pool(cfg, seed: int, size: int, n_views: int, n_targets: int,
              arkit: bool, device="cuda"):
    """``size`` distinct scenes of run ``seed``, scene i seeded by
    `scene_seed(seed, i)`."""
    return [make_scene(cfg, scene_seed(seed, i), n_views, n_targets, arkit,
                       device) for i in range(size)]
