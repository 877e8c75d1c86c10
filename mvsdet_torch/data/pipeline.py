"""Host-side multi-view pipeline: view sampling, image IO, batch build.

The port's copy of mvsdet_tpu/data/pipeline.py, a re-design of
`MultiViewPipeline_Tgt` (ref: projects/NeRF-Det/nerfdet/
multiview_pipeline.py:317-612):

  * 'random' / 'gap' / 'stride' view samplers with the reference's exact
    index arithmetic (:432-473);
  * image load -> resize -> normalise; depth load (mm png / npy);
  * fixed-shape numpy batches; staging to the card is `data/prefetch.py`'s
    and `evaluation/harness.py`'s.

`ScenePipeline` draws a batch's random choices (`sample`) apart from the
decoding (`load`), so that `scene_iterator` can advance the seeded stream
past scenes it does not decode: a resumed run, or one data row of
several, takes its own positions of the one stream.

The images are resized *exactly* to the static target (240x320) with
anisotropic intrinsic scaling (fx by the width ratio, fy by the height
ratio), where the reference resizes keep-ratio and pads: geometry stays
exact and every shape is static.

Image decoding: the port's native library (`data/native_loader.py`, g++
with libjpeg and libpng) where it builds, else cv2; where neither is there,
`default_image_loader` raises and names both.  Depth is read with cv2, as
the JAX pipeline reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from mvsdet_torch.config import Config
from mvsdet_torch.data import native_loader
from mvsdet_torch.data.infos import SceneInfo

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def sample_views_random(rng: np.random.RandomState, n_total: int,
                        n_images: int, n_targets: int):
    """'random' sampling (multiview_pipeline.py:432-441).

    Returns (src_ids, target_ids); note the reference's np.setdiff1d
    sorts and dedups the source ids.
    """
    ids = np.arange(n_total)
    replace = n_images > n_total
    ids = rng.choice(ids, n_images, replace=replace)
    target_ids = rng.choice(ids, n_targets, replace=False) if n_targets \
        else np.empty((0,), int)
    src = np.setdiff1d(ids, target_ids)
    return src, target_ids


def sample_views_gap(rng: np.random.RandomState, n_total: int,
                     n_images: int, n_targets: int):
    """'gap' sampling (multiview_pipeline.py:443-463): two held-out
    target runs inside the trajectory, surrounded by source views.

    Scenes too short to host the two target runs (the reference would
    crash on them) fall back to 'random' sampling.
    """
    ids = np.arange(n_total)
    half_t = n_targets // 2
    if n_total // 2 - half_t - 1 < 1 or n_total - half_t - 1 <= n_total // 2:
        return sample_views_random(rng, n_total, n_images, n_targets)
    src_1 = rng.randint(0, n_total // 2 - half_t - 1)
    src_3 = rng.randint(n_total // 2, n_total - half_t - 1)
    src_used = [src_1, src_1 + half_t + 1, src_3, src_3 + half_t + 1]
    target_ids = []
    for k in range(half_t):
        target_ids += [src_1 + 1 + k, src_3 + 1 + k]
    used = src_used + target_ids
    pool = np.setdiff1d(ids, np.asarray(used))
    n_rest = n_images - len(used)
    if n_rest < 0:
        # n_images too small to host the 4 anchor sources + targets
        return sample_views_random(rng, n_total, n_images, n_targets)
    replace = n_rest > len(pool)
    rest = rng.choice(pool, n_rest, replace=replace)
    src = np.concatenate([rest, np.asarray(src_used)])
    return src.astype(int), np.asarray(target_ids, int)


def sample_views_stride(n_total: int, n_images: int, sample_freq: int):
    """strided sampling (multiview_pipeline.py:466-473)."""
    return np.arange(0, n_images * sample_freq, sample_freq) % n_total


def cv2_load_rgb(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """Decode with cv2 and resize (INTER_LINEAR) to (h, w): (h, w, 3)
    uint8 RGB."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)


def cv2_load_depth(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """Depth in metres from a mm png or an npy, resized with cv2
    (multiview_pipeline.py:499-509)."""
    import cv2

    if path.endswith(".npy"):
        d = np.load(path)
    else:
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(path)
        d = d.astype(np.float32) / 1000.0
    return cv2.resize(d.astype(np.float32), (hw[1], hw[0]),
                      interpolation=cv2.INTER_LINEAR)


def default_image_loader() -> Callable:
    """The native library's image loader where it builds, else cv2's.
    Raises RuntimeError, naming both, where neither is available."""
    try:
        native_loader.load()
        return native_loader.load_resize_rgb
    except RuntimeError as exc:
        native_error = exc
    try:
        import cv2  # noqa: F401
    except ImportError as exc:
        raise RuntimeError(
            f"no image decoder: the native library is not available "
            f"({native_error}) and cv2 cannot be imported ({exc})") from exc
    return cv2_load_rgb


def _scale_k_xy(k: np.ndarray, sx: float, sy: float) -> np.ndarray:
    out = k.copy()
    out[..., 0, :] *= sx
    out[..., 1, :] *= sy
    return out


@dataclasses.dataclass
class ScenePlan:
    """What `ScenePipeline.sample` draws for one batch: the source and
    target view ids and the (shifted) volume origin."""

    src: np.ndarray
    tgt: np.ndarray
    origin: np.ndarray


@dataclasses.dataclass
class ScenePipeline:
    """Builds one fixed-shape model batch from a SceneInfo."""

    cfg: Config
    training: bool = True
    load_depth: bool = False
    # fn(path, (h, w)) -> (h, w, 3) uint8 RGB; `default_image_loader()`
    # where not given
    image_loader: Optional[Callable] = None

    def __post_init__(self):
        if self.image_loader is None:
            self.image_loader = default_image_loader()

    def sample(self, scene: SceneInfo,
               rng: np.random.RandomState) -> ScenePlan:
        """The random draws of one batch, in `__call__`'s order: the view
        sampler's, the padding of the source views to the static count,
        and (training) the origin shift.  Decodes nothing."""
        dc = self.cfg.data
        n_images = dc.n_views_train if self.training else dc.n_views_test
        n_targets = (dc.nerf_target_views_train if self.training
                     else dc.nerf_target_views_test)
        loading = dc.loading_train if self.training else dc.loading_test

        if loading == "gap":
            src, tgt = sample_views_gap(rng, scene.num_views, n_images,
                                        n_targets)
        elif loading == "random":
            src, tgt = sample_views_random(rng, scene.num_views, n_images,
                                           n_targets)
        else:
            src = sample_views_stride(scene.num_views, n_images - n_targets,
                                      dc.sample_freq)
            tgt = src[:n_targets]

        # pad/trim src to the static size (random sampler dedup may
        # shrink it)
        n_src = n_images - n_targets
        if len(src) < n_src:
            extra = rng.choice(src, n_src - len(src), replace=True)
            src = np.concatenate([src, extra])
        src = src[:n_src]

        origin = np.asarray(dc.origin, np.float32).copy()
        if self.training:
            # RandomShiftOrigin (multiview_pipeline.py:843-852)
            origin += rng.randn(3).astype(np.float32) * np.asarray(
                dc.shift_std, np.float32)
        return ScenePlan(src=src, tgt=tgt, origin=origin)

    def load(self, scene: SceneInfo, plan: ScenePlan) -> Dict[str, np.ndarray]:
        """Decode the views ``plan`` names and assemble the batch."""
        mc = self.cfg.model
        h, w = mc.image_size
        ht, wt = mc.target_size
        src, tgt = plan.src, plan.tgt
        load, load_depth = self.image_loader, cv2_load_depth

        imgs, denorms, depths = [], [], []
        for i in src:
            rgb = load(scene.img_paths[i], (h, w)).astype(np.float32)
            denorms.append(rgb / 255.0)
            imgs.append((rgb - IMAGENET_MEAN) / IMAGENET_STD)
            if self.load_depth:
                depths.append(load_depth(scene.depth_paths[i], (h, w)))

        gt_imgs = []
        for i in tgt:
            rgb = load(scene.img_paths[i], (ht, wt)).astype(np.float32)
            gt_imgs.append(rgb / 255.0)

        # anisotropic intrinsic scaling to the resized resolutions, from
        # the explicit per-dataset capture resolution on SceneInfo
        # (ScanNet posed RGB 968x1296, ARKit 192x256)
        ori_h, ori_w = scene.original_hw
        k_img = _scale_k_xy(scene.intrinsic, w / ori_w, h / ori_h)
        k_tgt = _scale_k_xy(scene.intrinsic, wt / ori_w, ht / ori_h)
        if k_img.ndim == 3:
            # ARKit per-view intrinsics (scannet_multiview_dataset.py:310-315):
            # select the sampled source/target views' K
            k_img = k_img[src]
            k_tgt = k_tgt[tgt]

        max_b = mc.head.max_boxes
        nb = min(len(scene.gt_boxes), max_b)
        box_dim = 7 if mc.head.with_yaw else 6   # ARKit carries yaw
        gt_boxes = np.zeros((max_b, box_dim), np.float32)
        gt_labels = np.zeros((max_b,), np.int32)
        gt_mask = np.zeros((max_b,), bool)
        if nb:
            gt_boxes[:nb] = scene.gt_boxes[:nb, :box_dim]
            gt_labels[:nb] = scene.gt_labels[:nb]
            gt_mask[:nb] = True

        batch = dict(
            images=np.stack(imgs),
            denorm_images=np.stack(denorms),
            w2c=scene.w2c[src],
            intrinsic=k_img.astype(np.float32),
            origin=plan.origin.copy(),
            tgt_c2w=scene.c2w[tgt],
            tgt_intrinsic=k_tgt.astype(np.float32),
            gt_images=np.stack(gt_imgs),
            gt_boxes=gt_boxes,
            gt_labels=gt_labels,
            gt_mask=gt_mask,
        )
        if self.load_depth:
            batch["depth"] = np.stack(depths)
            # target-view GT depth for the rendered-depth metric
            # (GaussianDepthMetric input, Indoor_NVS.py:231-283)
            batch["gt_depth"] = np.stack(
                [load_depth(scene.depth_paths[i], (ht, wt)) for i in tgt])
        return batch

    def __call__(self, scene: SceneInfo,
                 rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """One batch: `sample`'s draws from ``rng``, then `load`."""
        return self.load(scene, self.sample(scene, rng))


def scene_iterator(scenes: Sequence[SceneInfo], pipeline: ScenePipeline,
                   seed: int = 0, repeat: int = 1, shuffle: bool = True,
                   start: int = 0, stride: int = 1):
    """Endless (train, ``repeat=0``) or ``repeat``-pass (eval) batch
    generator over one seeded stream.

    Mirrors RepeatDataset x6 + DefaultSampler shuffle (config
    mvsdet_res50_2x_low_res.py:128-145).  Yields the batches at stream
    positions ``start``, ``start + stride``, ...: every position draws its
    scene order and its view samples from the one rng, but only the
    positions yielded are decoded.  A run resumed at step k of data row d
    (of D) takes ``start = k * D + d, stride = D`` and sees what an
    unbroken run sees there.
    """
    rng = np.random.RandomState(seed)
    epoch = 0
    position = 0
    while True:
        order = np.arange(len(scenes))
        if shuffle:
            rng.shuffle(order)
        for idx in order:
            plan = pipeline.sample(scenes[idx], rng)
            if position >= start and (position - start) % stride == 0:
                yield pipeline.load(scenes[idx], plan)
            position += 1
        epoch += 1
        if repeat and epoch >= repeat:
            return
