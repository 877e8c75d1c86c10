# Frozen copy of mvsdet_torch/models/mvsdet.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.  Cut to the paths the benchmark's cells
# drive: float32, one device, the mxu plane sweep, CostRegNet in
# GroupNorm, the tiled renderer, no depth supervision, no diagnostics.
"""MVSDet forward, loss and predict (port of mvsdet_tpu/models/mvsdet.py).

  images (N, H, W, 3)
    -> ResNet-50 + FPN level 0                  (N, h, w, C) channels-last
    -> kNN neighbour views
    -> view chunks: plane-sweep variance -> CostRegNet
       -> softmax depth prob + sigmoid offsets
    -> top-k depth hypotheses + expectation
    -> depth-weighted voxel lift (plain gather and sum)
    -> IndoorImVoxelNeck -> DetectionHead -> NMS
  and the Gaussian branch: top-3 source views per render target ->
  per-pixel Gaussians -> tile splatting (plain compositor).

`forward(batch, train)` is `MVSDet.__call__`; `loss` adds the head
losses and the novel-view MSE.  ScanNet's shared intrinsics and ARKit's
per-view and per-target ones both run, as do the aligned head and, in
predict, the ARKit yaw head (`head.with_yaw`).  The plane sweep is the
JAX module's default, the two-product shear warp
(`ops/plane_sweep_mxu.py`).  Public tensors keep the JAX package's
channels-last layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.config import ModelConfig
from benchmark.reference.geometry.cameras import (full_projection,
                                                  knn_camera_neighbors,
                                                  nearest_pose_ids,
                                                  scale_intrinsics)
from benchmark.reference.geometry.rays import (depth_scale_map,
                                               sample_image_grid)
from benchmark.reference.geometry.voxels import (depth_plane_values,
                                                 multiscale_voxel_points,
                                                 voxel_points)
from benchmark.reference.models.cost_reg import CostRegNet
from benchmark.reference.models.fpn import FPN
from benchmark.reference.models.gaussian_head import (Gaussians, ToGaussians,
                                                      adapt_gaussians)
from benchmark.reference.models.head import (DetectionHead, head_loss,
                                             head_predict,
                                             head_predict_rotated)
from benchmark.reference.models.layers import sigmoid
from benchmark.reference.models.neck3d import IndoorImVoxelNeck
from benchmark.reference.models.resnet import ResNet50
from benchmark.reference.ops.plane_sweep_mxu import plane_sweep_variance_mxu
from benchmark.reference.ops.sampling import bilinear_resize, linear_resize
from benchmark.reference.ops.splat_tiles import render_views_tiled
from benchmark.reference.ops.voxel_lift import (finalize_volume,
                                                lift_features_to_voxels)


def _upsample_valid(valid_count: torch.Tensor, shape3) -> torch.Tensor:
    """Lift validity per head level: the view-count volume resized as
    JAX's antialiased trilinear resize does (ROADMAP trap T2), >= 0.5."""
    return linear_resize(valid_count, shape3, (0, 1, 2)) >= 0.5


class MVSDet(nn.Module):
    """Single-scene MVSDet forward, loss and predict.

    Each sweep chunk (plane sweep and CostRegNet) is recomputed in
    backward instead of keeping its activations, the counterpart of
    `nn.remat` at mvsdet_tpu/models/mvsdet.py:157.
    """

    def __init__(self, cfg: ModelConfig, sweep_chunk: int = 8):
        super().__init__()
        if cfg.cost_reg_norm != "group" or cfg.gs.splat_impl != "tiled" \
                or cfg.depth_supervision:
            raise ValueError("the benchmark's reference runs CostRegNet in "
                             "GroupNorm, the tiled renderer and no depth "
                             "supervision")
        self.cfg = cfg
        self.sweep_chunk = sweep_chunk
        c = cfg.backbone.fpn_out_channels
        self.backbone = ResNet50(depth=cfg.backbone.depth,
                                 frozen_stages=cfg.backbone.frozen_stages)
        self.fpn = FPN(out_channels=c)
        self.cost_reg = CostRegNet(in_channels=c, norm=cfg.cost_reg_norm)
        self.neck3d = IndoorImVoxelNeck(in_channels=c,
                                        out_channels=cfg.neck3d_out_channels)
        self.head = DetectionHead(cfg.head,
                                  in_channels=cfg.neck3d_out_channels)
        gs_in = c + 1 + (3 if cfg.gs.use_rgb_gaussian else 0)
        self.to_gaussians = ToGaussians(
            gs_in, cfg.gs.num_surfaces * (2 + cfg.gs.adapter.d_in))

    # -- feature extraction ------------------------------------------------

    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, h, w, C) FPN level 0, channels-last."""
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        return self.fpn(feats)[0].permute(0, 2, 3, 1).contiguous()

    def depth_probabilities(self, features: torch.Tensor,
                            proj44: torch.Tensor, neighbor_ids: torch.Tensor,
                            train: bool = False):
        """View-chunked plane sweep + cost regularisation for every view
        (mvsdet.py:111-160).  With gradients on, each chunk runs under
        `torch.utils.checkpoint`: only its inputs are kept, and backward
        runs its forward again.

        Returns (prob, off), both (N, D, h, w): prob softmaxed over D, off
        sigmoided (mvsdet.py:470-475).
        """
        mc = self.cfg
        n = features.shape[0]
        ref_ids = torch.arange(n, device=features.device)
        depths = depth_plane_values(*mc.near_far_range,
                                    mc.gs.num_depth_planes,
                                    device=features.device)
        chunk = self.sweep_chunk
        if n % chunk != 0:
            chunk = 1 if n < chunk else max(
                c for c in range(1, chunk + 1) if n % c == 0)

        def step(ref_ids):
            var = plane_sweep_variance_mxu(features, proj44, ref_ids,
                                           neighbor_ids[ref_ids], depths)
            out = self.cost_reg(var.permute(0, 4, 1, 2, 3).contiguous(),
                                train)
            return torch.softmax(out[:, 0], dim=1), sigmoid(out[:, 1])

        probs, offs = [], []
        for ids in ref_ids.reshape(-1, chunk):
            p, o = (checkpoint(step, ids, use_reentrant=False)
                    if torch.is_grad_enabled() else step(ids))
            probs.append(p)
            offs.append(o)
        return torch.cat(probs), torch.cat(offs)

    def sample_depth(self, prob: torch.Tensor, off: torch.Tensor):
        """Top-k depth hypotheses and the expectation over all planes.

        Returns est_depth (N, h, w, K), est_prob (N, h, w, K) and
        depth_expect (N, h, w).
        """
        mc = self.cfg
        near = mc.near_far_range[0]
        interval = mc.depth_interval
        p = prob.permute(0, 2, 3, 1)                          # (N, h, w, D)
        o = off.permute(0, 2, 3, 1)
        # the top k by a stable descending sort: jax.lax.top_k takes the
        # lower plane first among equal probabilities; torch.topk promises
        # no order (ROADMAP F1, T15)
        top_p, top_idx = torch.sort(p, dim=-1, descending=True, stable=True)
        top_p, top_idx = top_p[..., :mc.topk], top_idx[..., :mc.topk]
        top_off = torch.gather(o, -1, top_idx)
        est_depth = top_idx * interval + near + top_off * interval
        plane = torch.arange(p.shape[-1], device=p.device) * interval + near
        depth_expect = ((plane + o * interval) * p).sum(dim=-1)
        return est_depth, top_p, depth_expect

    # -- gaussian branch ---------------------------------------------------

    def gaussian_branch(self, features, denorm_images, prob, depth_expect,
                        src_c2w, feat_intrinsic, tgt_c2w) -> Gaussians:
        """Per-pixel Gaussians from the nearest source views of every
        render target (mvsdet.py:519-677).  The reference's variable-size
        unique() is a fixed (T*k,) slot list whose duplicate slots get
        opacity 0.  Returns a flat Gaussian set (S*h*w,)."""
        mc = self.cfg
        n, h, w, c = features.shape
        dev = features.device
        k_sel = min(mc.gs.render_src_per_target, n - 1)
        sel = torch.sort(nearest_pose_ids(tgt_c2w, src_c2w, k_sel)
                         .reshape(-1)).values                 # (S,)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sel[1:] != sel[:-1]])
        s = sel.shape[0]

        feat_sel = features[sel].reshape(s, h * w, c)
        depth_code = depth_expect[sel].reshape(s, h * w, 1)
        gs_feat = [feat_sel, depth_code]
        if mc.gs.use_rgb_gaussian:
            rgb = bilinear_resize(denorm_images[sel], (h, w))  # (S, h, w, 3)
            gs_feat.append(rgb.reshape(s, h * w, 3))
        raw = self.to_gaussians(torch.cat(gs_feat, dim=-1))   # (S, hw, 2+d_in)
        offset_xy = sigmoid(raw[..., :2])

        xy, _ = sample_image_grid((h, w), device=dev)
        pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32,
                                  device=dev)
        coords = xy.reshape(1, h * w, 2) + (offset_xy - 0.5) * pixel_size

        # opacity = max depth probability (mvsdet.py:581-582), duplicates 0
        opacity = prob.amax(dim=1)[sel].reshape(s, h * w)
        opacity = opacity * first[:, None].to(opacity.dtype)

        # normalised source Ks: one shared K (ScanNet) or one per view
        # (ARKit, mvsdet.py:549-553)
        norm = torch.tensor([[w], [h], [1.0]], dtype=torch.float32, device=dev)
        if feat_intrinsic.ndim == 2:
            k_norm = (feat_intrinsic[:3, :3] / norm).expand(s, 3, 3)
            scale = depth_scale_map(h, w, feat_intrinsic[:3, :3])[None]
        else:
            k_norm = feat_intrinsic[sel, :3, :3] / norm
            scale = depth_scale_map(h, w, feat_intrinsic[:, :3, :3])[sel]
        ray_depth = depth_code[..., 0] / (scale[..., 0] + 1e-8)

        g = adapt_gaussians(src_c2w[sel], k_norm, coords, ray_depth, opacity,
                            raw[..., 2:], (h, w), mc.gs.adapter)
        flat = lambda t: t.reshape((s * h * w,) + t.shape[2:])
        return Gaussians(means=flat(g.means), covariances=flat(g.covariances),
                         harmonics=flat(g.harmonics),
                         opacities=flat(g.opacities))

    # -- full forward ------------------------------------------------------

    def extract_feat(self, batch: Dict[str, torch.Tensor],
                     train: bool = False):
        """Backbone -> sweep -> depth -> lift -> neck, and the Gaussian
        branch when the batch holds render targets.  ``train`` runs the
        neck's BatchNorm on batch statistics and updates its running ones.

        `batch` (one scene): images (N, H, W, 3) normalised;
        denorm_images (N, H, W, 3); w2c (N, 4, 4); intrinsic (4, 4) K at
        image resolution, or (N, 4, 4) one per view (ARKit); origin (3,);
        tgt_c2w (T, 4, 4); tgt_intrinsic (4, 4) K at target resolution, or
        (T, 4, 4) one per target.
        """
        mc = self.cfg
        feats = self.image_features(batch["images"])
        n = feats.shape[0]

        feat_intrinsic = scale_intrinsics(batch["intrinsic"],
                                          float(mc.feature_stride))
        proj44 = full_projection(batch["w2c"], feat_intrinsic)
        src_c2w = torch.linalg.inv_ex(batch["w2c"]).inverse
        neighbor_ids = knn_camera_neighbors(
            src_c2w[:, :3, 3], min(mc.plane_sweep_neighbors, n - 1))

        prob, off = self.depth_probabilities(feats, proj44, neighbor_ids,
                                             train)
        est_depth, est_prob, depth_expect = self.sample_depth(prob, off)

        points = voxel_points(mc.n_voxels, mc.voxel_size,
                              batch["origin"]).reshape(3, -1).T  # (V, 3)
        vol_sum, valid_cnt = lift_features_to_voxels(
            feats, proj44[:, :3, :4], est_depth, est_prob, points,
            mc.voxel_size[2])
        volume = finalize_volume(vol_sum, valid_cnt)          # (V, C)
        nx, ny, nz = mc.n_voxels
        volume = volume.reshape(nx, ny, nz, -1).permute(3, 0, 1, 2)[None]
        levels = self.neck3d(volume.contiguous(), train)

        gaussians = None
        if "tgt_c2w" in batch:
            gaussians = self.gaussian_branch(
                feats, batch["denorm_images"], prob, depth_expect, src_c2w,
                feat_intrinsic, batch["tgt_c2w"])
        return dict(levels=levels, valid_count=valid_cnt.reshape(nx, ny, nz),
                    depth_expect=depth_expect, gaussians=gaussians)

    def _target_intrinsics(self, batch, image_shape) -> torch.Tensor:
        """(T, 3, 3) target Ks normalised by the image size, from one
        shared K or one per target (ARKit, mvsdet.py:645-658)."""
        ht, wt = image_shape
        n_tgt = batch["tgt_c2w"].shape[0]
        tgt_k = batch["tgt_intrinsic"]
        norm = torch.tensor([[wt], [ht], [1.0]], dtype=torch.float32,
                            device=tgt_k.device)
        return (tgt_k[:3, :3] / norm).expand(n_tgt, 3, 3) if tgt_k.ndim == 2 \
            else tgt_k[:, :3, :3] / norm

    def render_targets(self, gaussians: Gaussians, batch, image_shape):
        """Splat the scene Gaussians into every render target view."""
        ks = self._target_intrinsics(batch, image_shape)
        bg = torch.tensor(self.cfg.gs.background_color, dtype=torch.float32,
                          device=ks.device)
        g = gaussians
        return render_views_tiled(
            g.means, g.covariances, g.harmonics, g.opacities,
            batch["tgt_c2w"], ks, image_shape, background=bg,
            capacity=self.cfg.gs.splat_capacity)

    def _head_points_and_valid(self, valid_count, origin):
        mc = self.cfg
        nx, ny, nz = mc.n_voxels
        sizes = [(nx >> i, ny >> i, nz >> i) for i in range(mc.head.n_levels)]
        pts = multiscale_voxel_points(sizes, mc.voxel_size, origin)
        valids = [_upsample_valid(valid_count, s).reshape(-1) for s in sizes]
        return pts, valids

    def forward(self, batch: Dict[str, torch.Tensor],
                train: bool = False) -> Dict:
        """Raw outputs (`MVSDet.__call__(train)`)."""
        out = self.extract_feat(batch, train)
        head_outs = self.head(out["levels"])
        pts, valids = self._head_points_and_valid(out["valid_count"],
                                                  batch["origin"])
        result = dict(head_outs=head_outs, points=pts, valids=valids, **out)
        if out["gaussians"] is not None and "gt_images" in batch:
            result["rendered"] = self.render_targets(
                out["gaussians"], batch, tuple(batch["gt_images"].shape[1:3]))
        return result

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training losses (`MVSDet.loss`, mvsdet.py:462-498): the aligned
        head's center, bbox and cls terms and `loss_nvs` (MSE of the
        rendered targets) when the batch holds them.  Runs the forward in
        train mode.

        Returns (total, aux): aux holds every term and `n_pos`.
        """
        mc = self.cfg
        if mc.head.with_yaw:
            raise ValueError("the benchmark's reference trains the aligned "
                             "head only")
        result = self(batch, train=True)
        losses, aux = head_loss(
            result["head_outs"], result["points"], result["valids"],
            batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"], mc.head)
        if "rendered" in result and mc.rgb_supervision:
            losses["loss_nvs"] = torch.mean(
                (result["rendered"] - batch["gt_images"]) ** 2)
        total = sum(losses.values())
        aux.update(losses)
        return total, aux

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """NMS'd boxes, rendered target views and the depth expectation
        (`MVSDet.predict`, mvsdet.py:500-547)."""
        result = self(batch)
        predict_fn = (head_predict_rotated if self.cfg.head.with_yaw
                      else head_predict)
        pred = predict_fn(result["head_outs"], result["points"],
                          result["valids"], self.cfg.head)
        if "rendered" in result:
            pred["rendered"] = result["rendered"]
        pred["depth_expect"] = result["depth_expect"]
        return pred
