# Frozen copy of mvsdet_torch/config.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Typed configuration for mvsdet_torch (a copy of mvsdet_tpu/config.py).

The port keeps its own copy so that it imports nothing of the JAX package.

Replaces the reference's mmengine python-dict config tower
(`projects/NeRF-Det/configs/mvsdet_res50_2x_low_res.py` and its `_base_`
chain) with plain frozen dataclasses.  Every numeric default mirrors the
reference config values (cited per-field below) so the ScanNet preset is
behaviourally equivalent.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class GaussianAdapterConfig:
    """Pixel-aligned Gaussian parameterisation.

    Reference: gs_cfg.gaussian_adapter_cfg in
    projects/NeRF-Det/configs/mvsdet_res50_2x_low_res.py:21-25.
    """

    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4

    @property
    def d_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        # 3 scales + 4 quaternion + 3*d_sh SH coefficients
        # (gs_src/model/encoder/common/gaussian_adapter.py:118-119)
        return 7 + 3 * self.d_sh


@dataclasses.dataclass(frozen=True)
class GaussianSplatConfig:
    """Gaussian-splatting branch configuration.

    Reference: `gs_cfg` dict in mvsdet_res50_2x_low_res.py:14-37.
    """

    use_rgb_gaussian: bool = True
    d_feature: int = 256
    num_depth_planes: int = 12          # num_monocular_samples
    num_surfaces: int = 1
    adapter: GaussianAdapterConfig = GaussianAdapterConfig()
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # top-k nearest source views per render target (mvsdet.py:532)
    render_src_per_target: int = 3
    # splatting implementation: "tiled" = Pallas tile rasterizer
    # (ops/splat_tiles.py, the fast path); "oracle" = exact O(pixels*G)
    # XLA compositor (ops/splat.py)
    splat_impl: str = "tiled"
    # max gaussians composited per 16x16 tile on the tiled path; tiles
    # overlapping more than this drop the farthest splats.  Chosen from
    # the on-chip capacity sweep at G=28.8k surface-concentrated
    # (experiments/splat_capacity_sweep_tpu.txt): 1024 truncates
    # (max err 0.146 vs oracle), 2048 is error-plateau exact (5.1e-3,
    # identical at 4096) for +20% renderer time (42->51 ms fwd)
    splat_capacity: int = 2048


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Anchor-free ImVoxelNet-style detection head.

    Reference: bbox_head dict in mvsdet_res50_2x_low_res_depth.py:37-46 and
    test_cfg at :61.
    """

    n_classes: int = 18
    n_levels: int = 3
    n_channels: int = 128
    n_reg_outs: int = 6                  # 7 for ARKit yaw head
    pts_assign_threshold: int = 27
    pts_center_threshold: int = 18
    with_yaw: bool = False
    # test cfg
    nms_pre: int = 1000
    iou_thr: float = 0.25
    score_thr: float = 0.01
    max_detections: int = 256            # static bound for jittable NMS output
    # loss weights (all 1.0 in the reference)
    center_loss_weight: float = 1.0
    bbox_loss_weight: float = 1.0
    cls_loss_weight: float = 1.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # static bound on GT boxes per scene for fixed-shape target assignment
    max_boxes: int = 64
    # ARKit yaw-box regression loss: "rotated_iou" = 1 - soft sampled
    # rotated 3D IoU (the reference's RotatedIoU3DLoss analogue,
    # nerfdet_head.py:71,647; ours: ops/nms.py rotated_iou_3d_soft_pairs),
    # "decoupled" = centre/log-size/sin-cos-yaw smooth-L1.  A/B on chip
    # (experiments/rotated_loss_ab.md): rotated_iou finishes 0.90/0.90
    # mAP@0.25/0.5 vs decoupled's 0.87/0.80 and avoids the decoupled
    # arm's transient collapse — reference-faithful AND better.
    rotated_bbox_loss: str = "rotated_iou"


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """ResNet-50 + FPN 2D feature extractor.

    Reference: backbone/neck dicts in mvsdet_res50_2x_low_res_depth.py:17-31.
    Only FPN level 0 (stride 4) is consumed (mvsdet.py:375).
    """

    depth: int = 50
    frozen_stages: int = 1               # stem + stage1 frozen
    fpn_out_channels: int = 256
    # BN is frozen everywhere in the backbone (norm_eval=True,
    # requires_grad=False — ..._depth.py:23-24)
    norm_eval: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level MVSDet model configuration (mvsdet_res50_2x_low_res.py:8-41)."""

    backbone: BackboneConfig = BackboneConfig()
    head: HeadConfig = HeadConfig()
    gs: GaussianSplatConfig = GaussianSplatConfig()

    n_voxels: Tuple[int, int, int] = (40, 40, 16)
    voxel_size: Tuple[float, float, float] = (0.16, 0.16, 0.2)
    near_far_range: Tuple[float, float] = (0.2, 5.0)
    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (-2.7, -2.7, -0.78),
        (3.7, 3.7, 1.78),
    )
    topk: int = 3                        # top-k depth hypotheses for lifting
    # CostRegNet normalisation: "group" (flagship; scan-safe and
    # batch-size independent — the reference's own GN variant,
    # mvs_models/mvsnet.py:116) or "batch" (the reference flagship's
    # BatchNorm3d, mvsnet.py:73-113 — exact-parity mode, validated
    # against the reference net in tests/test_torch_parity.py).  A/B on
    # chip (experiments/costreg_norm_ab.md): under the chunked view scan
    # BN trains but its per-chunk running stats diverge from train-mode
    # behaviour and eval mAP collapses to 0; GN trains AND evals stably.
    cost_reg_norm: str = "group"
    # voxel-lift gather backend: "xla" scan-gather (measured faster:
    # 35.5 vs 58.4 ms fwd at ScanNet scale on v5e,
    # experiments/lift_profile_tpu.txt) or "pallas" MXU one-hot kernel
    lift_impl: str = "xla"
    plane_sweep_neighbors: int = 2       # k in knn neighbour selection (mvsdet.py:432)
    rgb_supervision: bool = True
    depth_supervision: bool = False
    neck3d_out_channels: int = 128

    # static input geometry (images are resized/padded host-side to these)
    image_size: Tuple[int, int] = (240, 320)   # (H, W) after pad
    feature_stride: int = 4
    target_size: Tuple[int, int] = (120, 160)  # render-target (H, W)

    @property
    def feature_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.feature_stride,
                self.image_size[1] // self.feature_stride)

    @property
    def depth_interval(self) -> float:
        near, far = self.near_far_range
        return (far - near) / self.gs.num_depth_planes


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """View sampling + normalisation (mvsdet_res50_2x_low_res.py:81-126)."""

    n_views_train: int = 42              # total sampled views incl. targets
    n_views_test: int = 81
    nerf_target_views_train: int = 2
    nerf_target_views_test: int = 1
    loading_train: str = "gap"
    loading_test: str = "random"
    sample_freq: int = 3
    margin: int = 10
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    repeat: int = 6                      # RepeatDataset times
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.5)
    shift_std: Tuple[float, float, float] = (0.7, 0.7, 0.0)
    classes: Sequence[str] = (
        "cabinet", "bed", "chair", "sofa", "table", "door", "window",
        "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
        "showercurtrain", "toilet", "sink", "bathtub", "garbagebin",
    )

    @property
    def n_src_train(self) -> int:
        return self.n_views_train - self.nerf_target_views_train

    @property
    def n_src_test(self) -> int:
        return self.n_views_test - self.nerf_target_views_test


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW + MultiStepLR (mvsdet_res50_2x_low_res_depth.py:179-193)."""

    lr: float = 2e-4
    weight_decay: float = 1e-4
    backbone_lr_mult: float = 0.1
    grad_clip_norm: float = 35.0
    max_epochs: int = 12
    milestones: Tuple[int, ...] = (8, 11)
    gamma: float = 0.1


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for pjit/shard_map training."""

    data_axis: int = 1                   # scenes per step = data_axis size
    view_axis: int = 1                   # shards of the per-scene view axis


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    parallel: ParallelConfig = ParallelConfig()
    seed: int = 0


def scannet_config() -> Config:
    """The flagship preset == reference `mvsdet_res50_2x_low_res.py`."""
    return Config()


ARKIT_CLASSES = (
    "cabinet", "refrigerator", "shelf", "stove", "bed",
    "sink", "washer", "toilet", "bathtub", "oven",
    "dishwasher", "fireplace", "stool", "chair", "table",
    "tv_monitor", "sofa",
)


def arkit_config() -> Config:
    """ARKitScenes preset: per-view intrinsics + 7-DoF yaw head.

    Reference: projects/NeRF-Det/configs/mvsdet_arkit_base.py +
    mvsdet_arkit.py — 17 classes (:71-76), 7 reg outs / rotated boxes,
    near_far [0.5, 5.5] (mvsdet_arkit.py:15), 42 train / 101 test views
    with 2/1 targets (:91,101,114,124), 'gap' loading (the flagship
    mvsdet_arkit.py:102 overrides the base's 'random'), RepeatDataset x2
    (base :156), per-view intrinsics paths (mvsdet.py:421-428).  ARKit
    lowres captures are 192x256.
    """
    base = Config()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(
            base.model,
            near_far_range=(0.5, 5.5),
            head=dataclasses.replace(
                base.model.head, n_classes=17, n_reg_outs=7, with_yaw=True),
        ),
        data=dataclasses.replace(
            base.data,
            n_views_train=42, n_views_test=101,
            nerf_target_views_train=2, nerf_target_views_test=1,
            loading_train="gap", repeat=2,
            classes=ARKIT_CLASSES,
        ),
    )


def tiny_test_config() -> Config:
    """Miniature config for CPU unit tests: tiny shapes, same code paths."""
    base = Config()
    model = dataclasses.replace(
        base.model,
        n_voxels=(8, 8, 4),
        # spatial dims must stay divisible by 4 through the U-Nets
        image_size=(32, 48),
        target_size=(16, 24),
        gs=dataclasses.replace(
            base.model.gs, num_depth_planes=4,
            adapter=GaussianAdapterConfig(sh_degree=1),
        ),
        head=dataclasses.replace(
            base.model.head, n_classes=5, max_boxes=8, nms_pre=64,
            max_detections=32,
        ),
        topk=2,
    )
    data = dataclasses.replace(
        base.data, n_views_train=6, n_views_test=6,
        nerf_target_views_train=2, nerf_target_views_test=1,
    )
    return dataclasses.replace(base, model=model, data=data)
