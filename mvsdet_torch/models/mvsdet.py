"""MVSDet forward, loss and predict (port of mvsdet_tpu/models/mvsdet.py).

  images (N, H, W, 3)
    -> ResNet-50 + FPN level 0                  (N, h, w, C) channels-last
    -> kNN neighbour views
    -> view chunks: plane-sweep variance -> CostRegNet
       -> softmax depth prob + sigmoid offsets
    -> top-k depth hypotheses + expectation
    -> depth-weighted voxel lift (CUDA gather kernel on the card)
    -> IndoorImVoxelNeck -> DetectionHead -> NMS
  and the Gaussian branch: top-3 source views per render target ->
  per-pixel Gaussians -> tile splatting (CUDA compositor on the card).

`forward(batch, train)` is `MVSDet.__call__`; `loss` adds the head
losses, the novel-view MSE and the optional depth L1.  ScanNet's shared
intrinsics and ARKit's per-view and per-target ones both run, as do the
aligned head and the ARKit yaw head (`head.with_yaw`), and CostRegNet in
GroupNorm or BatchNorm mode.  Given a view group (`parallel/`), a scene's
views are sharded over its ranks as the JAX module's `view_axis` shards
them (mvsdet_tpu/models/mvsdet.py:283-358).  The plane sweep is the
bilinear gather (`sweep_method="gather"` of the JAX module).
Public tensors keep the JAX package's channels-last layout.

``dtype`` is the JAX module's compute dtype: the networks compute in it
(bf16 is the configuration the JAX package benchmarks and trains), while
parameters, statistics, gradients and optimizer state stay float32.
Values go to and from it where the JAX module casts them
(mvsdet_tpu/models/mvsdet.py:152-154, 285, 301, 330, 349): the images
in; the features back to float32 for the sweep and the Gaussian branch
and in the compute dtype to the lift, which returns float32; the sweep's
variance into CostRegNet and its logits back out; the volume into the
neck.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvsdet_torch.config import Config, ModelConfig
from mvsdet_torch.geometry.cameras import (full_projection,
                                           knn_camera_neighbors,
                                           nearest_pose_ids, scale_intrinsics)
from mvsdet_torch.geometry.rays import depth_scale_map, sample_image_grid
from mvsdet_torch.geometry.voxels import (depth_plane_values,
                                          multiscale_voxel_points,
                                          voxel_points)
from mvsdet_torch.models.cost_reg import CostRegNet
from mvsdet_torch.models.fpn import FPN
from mvsdet_torch.models.gaussian_head import (Gaussians, ToGaussians,
                                               adapt_gaussians)
from mvsdet_torch.models.head import (DetectionHead, head_loss,
                                      head_loss_rotated, head_predict,
                                      head_predict_rotated)
from mvsdet_torch.models.layers import sigmoid
from mvsdet_torch.models.neck3d import IndoorImVoxelNeck
from mvsdet_torch.models.resnet import ResNet50
from mvsdet_torch.ops.plane_sweep import plane_sweep_variance_for_refs
from mvsdet_torch.ops.sampling import bilinear_resize, linear_resize
from mvsdet_torch.ops.splat_tiles import render_views_tiled
from mvsdet_torch.ops.voxel_lift import finalize_volume, lift_features_to_voxels
from mvsdet_torch.parallel.collectives import all_gather_views, psum


DEPTH_SUPERVISION_SHARDED = (
    "depth_supervision with the views sharded over more than one rank: "
    "the JAX step compares each rank's shard of the depth maps with the "
    "depth estimate of every view, which fails or means nothing; train "
    "with --view-parallel 1 or without depth supervision")


def _upsample_valid(valid_count: torch.Tensor, shape3) -> torch.Tensor:
    """Lift validity per head level: the view-count volume resized as
    JAX's antialiased trilinear resize does (ROADMAP trap T2), >= 0.5."""
    return linear_resize(valid_count, shape3, (0, 1, 2)) >= 0.5


class MVSDet(nn.Module):
    """Single-scene MVSDet forward, loss and predict.

    ``sweep_remat`` recomputes each sweep chunk (plane sweep and
    CostRegNet) in backward instead of keeping its activations, the
    counterpart of `nn.remat` at mvsdet_tpu/models/mvsdet.py:157.
    ``dtype`` is the networks' compute dtype (float32 or bfloat16).
    """

    def __init__(self, cfg: ModelConfig, sweep_chunk: int = 8,
                 sweep_remat: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.gs.splat_impl != "tiled":
            raise NotImplementedError("only the tiled splatting path is "
                                      "ported")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype float32 or bfloat16, not "
                             f"{dtype}")
        self.cfg = cfg
        self.sweep_chunk = sweep_chunk
        self.sweep_remat = sweep_remat
        self.dtype = dtype
        c = cfg.backbone.fpn_out_channels
        self.backbone = ResNet50(depth=cfg.backbone.depth,
                                 frozen_stages=cfg.backbone.frozen_stages,
                                 dtype=dtype)
        self.fpn = FPN(out_channels=c, dtype=dtype)
        self.cost_reg = CostRegNet(in_channels=c, norm=cfg.cost_reg_norm,
                                   dtype=dtype)
        self.neck3d = IndoorImVoxelNeck(in_channels=c,
                                        out_channels=cfg.neck3d_out_channels,
                                        dtype=dtype)
        self.head = DetectionHead(cfg.head, in_channels=cfg.neck3d_out_channels,
                                  dtype=dtype)
        gs_in = c + 1 + (3 if cfg.gs.use_rgb_gaussian else 0)
        self.to_gaussians = ToGaussians(
            gs_in, cfg.gs.num_surfaces * (2 + cfg.gs.adapter.d_in),
            dtype=dtype)

    # -- feature extraction ------------------------------------------------

    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, h, w, C) FPN level 0, channels-last,
        in the compute dtype."""
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        return self.fpn(feats)[0].permute(0, 2, 3, 1).contiguous()

    def depth_probabilities(self, features: torch.Tensor, proj44: torch.Tensor,
                            neighbor_ids: torch.Tensor, train: bool = False,
                            ref_ids: Optional[torch.Tensor] = None):
        """View-chunked plane sweep + cost regularisation, for every view
        or, given ``ref_ids``, for those reference views only (a view
        rank's own, mvsdet.py:111-160).

        With gradients on and ``sweep_remat``, each chunk runs under
        `torch.utils.checkpoint`: only its inputs are kept, and backward
        runs its forward again.  Training CostRegNet in BatchNorm mode runs
        one chunk of all N views, as the JAX module does
        (mvsdet_tpu/models/mvsdet.py:128-139), so that its statistics are
        the whole batch's, and without checkpoint: a recompute in backward
        would move the running statistics a second time (ROADMAP T21).

        Returns (prob, off), both (N, D, h, w) float32 (N the count of
        ``ref_ids`` where given): prob softmaxed over D, off sigmoided
        (mvsdet.py:470-475).  The float32 variance
        goes into CostRegNet in the compute dtype and its logits come back
        to float32 before the softmax and the sigmoid.
        """
        mc = self.cfg
        if ref_ids is None:
            ref_ids = torch.arange(features.shape[0], device=features.device)
        n = ref_ids.shape[0]
        depths = depth_plane_values(*mc.near_far_range,
                                    mc.gs.num_depth_planes,
                                    device=features.device)
        batch_stats = mc.cost_reg_norm == "batch" and train
        chunk = n if batch_stats else self.sweep_chunk
        if n % chunk != 0:
            chunk = 1 if n < chunk else max(
                c for c in range(1, chunk + 1) if n % c == 0)

        def step(ref_ids):
            var = plane_sweep_variance_for_refs(
                features, proj44, ref_ids, neighbor_ids[ref_ids], depths)
            out = self.cost_reg(
                var.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(), train)
            out = out.to(torch.float32)
            return torch.softmax(out[:, 0], dim=1), sigmoid(out[:, 1])

        remat = (self.sweep_remat and torch.is_grad_enabled()
                 and not batch_stats)
        probs, offs = [], []
        for ids in ref_ids.reshape(-1, chunk):
            p, o = (checkpoint(step, ids, use_reentrant=False) if remat
                    else step(ids))
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
        # lower plane first among equal probabilities, which bf16 logits
        # make common; torch.topk promises no order (ROADMAP F1, T15)
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
                     train: bool = False, view=None):
        """Backbone -> sweep -> depth -> lift -> neck, and the Gaussian
        branch when the batch holds render targets.  ``train`` runs the
        neck's BatchNorm on batch statistics and updates its running ones.

        With ``view``, a process group over which the scene's views are
        sharded (mvsdet.py:283-358): ``images`` and ``denorm_images`` hold
        this rank's consecutive slice of the views, the camera arrays all
        of them.  The local features are all-gathered in float32; this
        rank sweeps its own reference views against the whole set, whose
        depth probabilities are gathered again; it lifts its own views
        (K3), and the volume and the view counts are summed over the
        group.  The neck, the head and the Gaussian branch (on the
        gathered images) then run on every rank.  Backward sums each
        collective's cotangents over the group (`parallel/collectives.py`).

        `batch` (one scene): images (N, H, W, 3) normalised;
        denorm_images (N, H, W, 3); w2c (N, 4, 4); intrinsic (4, 4) K at
        image resolution, or (N, 4, 4) one per view (ARKit); origin (3,);
        tgt_c2w (T, 4, 4); tgt_intrinsic (4, 4) K at target resolution, or
        (T, 4, 4) one per target.
        """
        mc = self.cfg
        local = self.image_features(batch["images"].to(self.dtype))
        local = local.to(torch.float32)     # the sweep's and the splats'
        if view is not None:
            feats = all_gather_views(local, view)
            n_local = local.shape[0]
            first = dist.get_rank(view) * n_local
            ref_ids = torch.arange(first, first + n_local,
                                   device=local.device)
        else:
            feats, ref_ids = local, None
        n = feats.shape[0]

        feat_intrinsic = scale_intrinsics(batch["intrinsic"],
                                          float(mc.feature_stride))
        proj44 = full_projection(batch["w2c"], feat_intrinsic)
        src_c2w = torch.linalg.inv_ex(batch["w2c"]).inverse
        neighbor_ids = knn_camera_neighbors(
            src_c2w[:, :3, 3], min(mc.plane_sweep_neighbors, n - 1))

        prob, off = self.depth_probabilities(feats, proj44, neighbor_ids,
                                             train, ref_ids)
        if view is not None:
            prob = all_gather_views(prob, view)
            off = all_gather_views(off, view)
        est_depth, est_prob, depth_expect = self.sample_depth(prob, off)

        points = voxel_points(mc.n_voxels, mc.voxel_size,
                              batch["origin"]).reshape(3, -1).T  # (V, 3)
        # the lift gathers rows in the compute dtype (lossless: they are
        # the FPN's own values) and accumulates in float32
        own = slice(None) if view is None \
            else slice(first, first + n_local)
        vol_sum, valid_cnt = lift_features_to_voxels(
            feats[own].to(self.dtype), proj44[own, :3, :4], est_depth[own],
            est_prob[own], points, mc.voxel_size[2])
        if view is not None:
            vol_sum = psum(vol_sum, view)
            valid_cnt = psum(valid_cnt, view)
        volume = finalize_volume(vol_sum, valid_cnt)          # (V, C)
        nx, ny, nz = mc.n_voxels
        volume = volume.to(self.dtype).reshape(nx, ny, nz, -1) \
            .permute(3, 0, 1, 2)[None]
        levels = self.neck3d(volume.contiguous(), train)

        gaussians = None
        if "tgt_c2w" in batch:
            denorm = batch["denorm_images"]
            if view is not None:
                denorm = all_gather_views(denorm, view)
            gaussians = self.gaussian_branch(
                feats, denorm, prob, depth_expect, src_c2w, feat_intrinsic,
                batch["tgt_c2w"])
        return dict(levels=levels, valid_count=valid_cnt.reshape(nx, ny, nz),
                    est_depth=est_depth, est_prob=est_prob,
                    depth_expect=depth_expect, gaussians=gaussians, prob=prob,
                    proj44=proj44)

    def render_targets(self, gaussians: Gaussians, batch, image_shape):
        """Splat the scene Gaussians into every render target view, with
        one shared target K or one per target (ARKit, mvsdet.py:645-658)."""
        ht, wt = image_shape
        n_tgt = batch["tgt_c2w"].shape[0]
        tgt_k = batch["tgt_intrinsic"]
        norm = torch.tensor([[wt], [ht], [1.0]], dtype=torch.float32,
                            device=tgt_k.device)
        ks = (tgt_k[:3, :3] / norm).expand(n_tgt, 3, 3) if tgt_k.ndim == 2 \
            else tgt_k[:, :3, :3] / norm
        bg = torch.tensor(self.cfg.gs.background_color, dtype=torch.float32,
                          device=tgt_k.device)
        return render_views_tiled(
            gaussians.means, gaussians.covariances, gaussians.harmonics,
            gaussians.opacities, batch["tgt_c2w"], ks, image_shape,
            background=bg, capacity=self.cfg.gs.splat_capacity)

    def _head_points_and_valid(self, valid_count, origin):
        mc = self.cfg
        nx, ny, nz = mc.n_voxels
        sizes = [(nx >> i, ny >> i, nz >> i) for i in range(mc.head.n_levels)]
        pts = multiscale_voxel_points(sizes, mc.voxel_size, origin)
        valids = [_upsample_valid(valid_count, s).reshape(-1) for s in sizes]
        return pts, valids

    def forward(self, batch: Dict[str, torch.Tensor],
                train: bool = False, view=None) -> Dict:
        """Raw outputs (`MVSDet.__call__(train, view_axis)`); ``view`` as
        `extract_feat` takes it."""
        out = self.extract_feat(batch, train, view)
        head_outs = self.head(out["levels"])
        pts, valids = self._head_points_and_valid(out["valid_count"],
                                                  batch["origin"])
        result = dict(head_outs=head_outs, points=pts, valids=valids, **out)
        if out["gaussians"] is not None and "gt_images" in batch:
            result["rendered"] = self.render_targets(
                out["gaussians"], batch, tuple(batch["gt_images"].shape[1:3]))
        return result

    def loss(self, batch: Dict[str, torch.Tensor], data_group=None,
             view=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training losses (`MVSDet.loss`, mvsdet.py:462-498): the head's
        center, bbox and cls terms, `loss_nvs` (MSE of the rendered
        targets) when the batch holds them, and `loss_depth` (L1 against
        the source views' depth resized to the feature grid) with
        `depth_supervision`.  Runs the forward in train mode.

        ``data_group``: the ranks whose scenes' positive counts the head
        loss averages (mvsdet_tpu/models/head.py:245-248); ``view``: the
        group the scene's views are sharded over (`extract_feat`).  The
        depth L1 and view sharding together raise: the JAX module compares
        a shard's depth maps with every view's estimate there
        (`parallel/sharding.py`, ROADMAP §3).

        Returns (total, aux): aux holds every term and `n_pos` (this
        scene's).
        """
        mc = self.cfg
        if view is not None and mc.depth_supervision:
            raise ValueError(DEPTH_SUPERVISION_SHARDED)
        result = self(batch, train=True, view=view)
        loss_fn = head_loss_rotated if mc.head.with_yaw else head_loss
        losses, aux = loss_fn(
            result["head_outs"], result["points"], result["valids"],
            batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"], mc.head,
            data_group=data_group)
        if "rendered" in result and mc.rgb_supervision:
            losses["loss_nvs"] = torch.mean(
                (result["rendered"] - batch["gt_images"]) ** 2)
        if mc.depth_supervision and "depth" in batch:
            est = result["depth_expect"]                      # (N, h, w)
            gt = bilinear_resize(batch["depth"][..., None],
                                 tuple(est.shape[1:3]))[..., 0]
            mask = gt > 0
            losses["loss_depth"] = (
                torch.where(mask, (est - gt).abs(), 0.0).sum()
                / torch.clamp_min(mask.sum().to(est.dtype), 1.0))
        total = sum(losses.values())
        aux.update(losses)
        return total, aux

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """NMS'd boxes, rendered target views and the depth expectation
        (`MVSDet.predict(diagnostics=False)`, mvsdet.py:500-547)."""
        result = self(batch)
        predict_fn = (head_predict_rotated if self.cfg.head.with_yaw
                      else head_predict)
        pred = predict_fn(result["head_outs"], result["points"],
                          result["valids"], self.cfg.head)
        if "rendered" in result:
            pred["rendered"] = result["rendered"]
        pred["depth_expect"] = result["depth_expect"]
        return pred


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn as flax initialises the JAX module: conv and
    dense kernels lecun-normal truncated at two standard deviations, zero
    biases, the head's class prior bias -4.595, unit norms and scales.
    Every draw comes from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                            nn.Linear)):
            w = mod.weight
            in_ch = w.shape[0] if isinstance(mod, nn.ConvTranspose3d) \
                else w.shape[1]
            # 0.8796: the std of a unit normal truncated to [-2, 2]
            std = (in_ch * w[0, 0].numel()) ** -0.5 / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
    if isinstance(getattr(model, "head", None), DetectionHead):
        with torch.no_grad():
            model.head.conv_cls.bias.fill_(-4.595)   # prior probability 0.01


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32,
                sweep_chunk: int = 8) -> MVSDet:
    """An eval-mode `MVSDet` for ``cfg`` computing in ``dtype``, with random
    float32 weights from ``generator`` (default: seeded with
    ``cfg.seed``), on ``device``; its plane sweep runs ``sweep_chunk``
    reference views at a time.

    Runs on the card unless the caller asks for the CPU; raises when CUDA
    is missing and ``device="cpu"`` was not asked for.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    model = MVSDet(cfg.model, sweep_chunk=sweep_chunk, dtype=dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.to(device).eval()
