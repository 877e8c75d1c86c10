"""Reader for the NeRF-Det/MVSDet info pickles.

A copy of mvsdet_tpu/data/infos.py, so the port imports nothing of the
JAX package.

Parses the ``*_infos_{train,val}_new.pkl`` format produced by the
reference's `prepare_infos.py` (ref:
projects/NeRF-Det/prepare_infos.py:22-103): a dict with ``metainfo``
(categories) and ``data_list`` of per-scene records carrying ``cam2img``,
``lidar2cam`` (per view), ``img_paths``, ``axis_align_matrix`` and
``instances`` ([{bbox_3d, bbox_label_3d}]).

Derived per-view quantities follow the reference dataset
(`MultiViewScanNetDataset.parse_data_info`,
scannet_multiview_dataset.py:100-168):
  w2c  = inv(axis_align @ lidar2cam)
  c2w  = axis_align @ lidar2cam   (note: the reference names are swapped
         relative to convention; its 'extrinsic' = inv(aa@l2c) maps
         world->camera and its 'c2w' = aa@l2c)
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SceneInfo:
    """One scene's static metadata."""

    img_paths: List[str]
    depth_paths: List[str]
    intrinsic: np.ndarray          # (4, 4) cam2img (shared; ARKit: (N, 4, 4))
    w2c: np.ndarray                # (N, 4, 4) world->camera
    c2w: np.ndarray                # (N, 4, 4) camera->world
    gt_boxes: np.ndarray           # (B, 6|7) gravity-centred boxes
    gt_labels: np.ndarray          # (B,)
    # original capture resolution the intrinsics are calibrated for —
    # explicit per dataset (ScanNet posed RGB: 968x1296,
    # scannet_multiview_dataset.py resize source; ARKit: 192x256)
    original_hw: tuple = (968, 1296)

    @property
    def num_views(self) -> int:
        return len(self.img_paths)


def load_infos(pkl_path: str, data_root: str = "",
               classes: Optional[Sequence[str]] = None,
               original_hw: tuple = (968, 1296)) -> List[SceneInfo]:
    """Load and convert all scene records.

    Args:
      pkl_path: path to ``*_infos_*_new.pkl``.
      data_root: prefix joined onto image paths.
      classes: optional class filter; labels outside are dropped
        (the reference's ``_remove_dontcare``).
      original_hw: calibrated capture resolution for intrinsic rescale
        (overridden per record by an ``original_hw`` key when present).

    Returns:
      list of `SceneInfo`.
    """
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    scenes = []
    for rec in data["data_list"]:
        axis_align = np.asarray(rec.get("axis_align_matrix", np.eye(4)),
                                np.float64)
        lidar2cam = np.asarray(rec["lidar2cam"], np.float64)  # (N, 4, 4)
        c2w = (axis_align[None] @ lidar2cam).astype(np.float32)
        w2c = np.linalg.inv(c2w).astype(np.float32)
        img_paths = [os.path.join(data_root, p) for p in rec["img_paths"]]
        if "depth_paths" in rec:
            # ARKit records carry explicit depth paths
            # (scannet_multiview_dataset.py:303-306)
            depth_paths = [os.path.join(data_root, p)
                           for p in rec["depth_paths"]]
        else:
            depth_paths = [p[:-4] + ".png" for p in img_paths]

        boxes, labels = [], []
        for inst in rec.get("instances", []):
            label = inst.get("bbox_label_3d", -1)
            if label is None or label < 0:
                continue
            boxes.append(np.asarray(inst["bbox_3d"], np.float32))
            labels.append(label)
        gt_boxes = (np.stack(boxes) if boxes
                    else np.zeros((0, 6), np.float32))
        # reference GT boxes are bottom-centred (origin z=0.5 applied in
        # DepthInstance3DBoxes with origin=(.5,.5,.5) — already gravity
        # centred in the new pkl format); keep as-is
        gt_labels = np.asarray(labels, np.int32)

        intrinsic = np.asarray(rec["cam2img"], np.float32)
        if intrinsic.ndim == 2 and intrinsic.shape == (3, 3):
            k4 = np.eye(4, dtype=np.float32)
            k4[:3, :3] = intrinsic
            intrinsic = k4
        elif intrinsic.ndim == 3 and intrinsic.shape[1:] == (3, 3):
            # ARKit per-view Ks (scannet_multiview_dataset.py:310-315)
            k4 = np.tile(np.eye(4, dtype=np.float32),
                         (intrinsic.shape[0], 1, 1))
            k4[:, :3, :3] = intrinsic
            intrinsic = k4

        scenes.append(SceneInfo(
            img_paths=img_paths, depth_paths=depth_paths,
            intrinsic=intrinsic, w2c=w2c, c2w=c2w,
            gt_boxes=gt_boxes, gt_labels=gt_labels,
            original_hw=tuple(rec.get("original_hw", original_hw))))
    return scenes
