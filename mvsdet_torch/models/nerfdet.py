"""Legacy NeRF-Det detector (port of mvsdet_tpu/models/nerfdet.py;
reference: projects/NeRF-Det/nerfdet/nerfdet.py:20-632), the reference's
second trainable model family: the detection backbone of MVSDet with an
unweighted voxel lift and a NeRF volume-rendering branch in place of the
plane sweep and the Gaussians.

  images -> ResNet-50 + FPN level 0
    -> simple backproject (every in-frustum voxel, nerfdet.py:570-632)
    -> mean volume (and exp(-variance))            (:220-231)
    -> [nerf_density] NeRF density at the voxel centres scales the mean
       volume                                      (:281-318)
    -> IndoorImVoxelNeck -> DetectionHead -> NMS
  NeRF branch ('image' mode, render_ray.py:231-305): target rays ->
    stratified points -> projected into every source view -> bilinear
    RGB and mapped-feature samples -> masked mean / exp(-var) -> VanillaNeRF
    -> composite -> masked MSE and the depth L1.

The branch's random draws (the rays' targets and pixels, the samples'
offsets in their strata) come from a `torch.Generator` or are handed in
as `rays` (`draw_rays`'s dict); the JAX module draws them from its 'rays'
PRNG key.  NeRF-Det takes one intrinsic shared by the views and one by
the targets (4, 4), as the JAX module does.  ``dtype`` is the JAX
module's compute dtype (float32 or bfloat16): the backbone, FPN, neck,
head, NeRF MLP and `mapping` compute in it, while the features that the
lift and the NeRF branch sample (`feats32`), the volumes and their
pooling stay float32, as in the JAX module; where a bf16 output meets a
float32 one (the sampled mapped features, the RGB and mapped volumes,
alpha times the mean volume, the rendered depth) both packages promote
to float32.  Public tensors keep the JAX package's channels-last layout.

No part of NeRF-Det runs a CUDA kernel of `ops/csrc`: its lift is a
nearest-pixel gather, its branch gathers, elementwise passes and small
MLPs, all of them PyTorch on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from mvsdet_torch.config import ModelConfig
from mvsdet_torch.geometry.cameras import compute_projection
from mvsdet_torch.geometry.rays import pixel_ray_dirs
from mvsdet_torch.geometry.voxels import multiscale_voxel_points, voxel_points
from mvsdet_torch.models.fpn import FPN
from mvsdet_torch.models.head import DetectionHead, head_loss, head_predict
from mvsdet_torch.models.layers import Linear
from mvsdet_torch.models.mvsdet import _upsample_valid
from mvsdet_torch.models.neck3d import IndoorImVoxelNeck
from mvsdet_torch.models.nerf_mlp import VanillaNeRF
from mvsdet_torch.models.resnet import ResNet50
from mvsdet_torch.ops import ray_render
from mvsdet_torch.utils.precision import feinsum

# the rays' pixels keep this far from the target's border (nerfdet.py:185)
RAY_MARGIN = 4

SHARED_INTRINSICS = (
    "NeRF-Det takes one intrinsic (4, 4) shared by the source views and one "
    "shared by the targets, as the JAX module does (feat_k[:3, :3], "
    "mvsdet_tpu/models/nerfdet.py:141-143); this batch has one per view "
    "(ARKit), which it gives no meaning")


def simple_backproject(features: torch.Tensor, proj34: torch.Tensor,
                       points: torch.Tensor):
    """Unweighted nearest-pixel voxel lifting (`backproject`,
    nerfdet.py:570-632 with depth=None).

    Each voxel centre takes the feature at its projection rounded half to
    even in every view where it falls in the image in front of the
    camera.  Validity is decided on the rounded float: a point near z = 0
    divides by 1e-9 and gives a huge or infinite pixel, which is invalid,
    whatever a cast to an integer would return.

    Args:
      features: (N, h, w, C); proj34: (N, 3, 4); points: (V, 3).

    Returns:
      per-view volume (N, V, C), zero where invalid, and valid (N, V).
    """
    n, h, w, c = features.shape
    homo = torch.cat([points, torch.ones_like(points[:, :1])], dim=-1)
    p = feinsum("nij,vj->nvi", proj34, homo)                   # (N, V, 3)
    z = p[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
    x = torch.round(p[..., 0] / z_safe)
    y = torch.round(p[..., 1] / z_safe)
    valid = (x >= 0) & (y >= 0) & (x < w) & (y < h) & (z > 0)
    pix = (torch.clamp(y, 0, h - 1) * w + torch.clamp(x, 0, w - 1)).long()
    base = torch.arange(n, device=features.device)[:, None] * (h * w)
    vals = features.reshape(n * h * w, c).index_select(
        0, (base + pix).reshape(-1)).reshape(n, -1, c)
    return vals * valid[..., None].to(vals.dtype), valid


def sum_views(x: torch.Tensor) -> torch.Tensor:
    """The sum over the views (dim 0), added view by view in order, as
    XLA's reduce adds on the CPU (torch's sum adds in another order), so
    that the volumes are bit-equal to the JAX package's there.  The views
    come from one `unbind`, whose backward stacks their gradients once
    (indexing view i would fill and add a zero tensor of the whole
    volume's size for each view in backward)."""
    views = x.unbind(0)
    total = views[0]
    for view in views[1:]:
        total = total + view
    return total


def mean_cov_volumes(per_view: torch.Tensor, valid: torch.Tensor):
    """Mean volume and exp(-variance) volume over the views
    (nerfdet.py:220-231).  The variance sums (x - mean)^2 over all N
    views, a zeroed invalid view's included, as the reference does.

    Args:
      per_view: (N, V, C); valid: (N, V).

    Returns:
      mean (V, C), zero where no view sees the voxel; exp(-var) (V, C),
      ~0 there; and the view count (V,).
    """
    cnt = torch.sum(valid.to(torch.float32), dim=0)
    mean = sum_views(per_view) / (cnt[:, None] + 1e-8)
    mean = torch.where(cnt[:, None] > 0, mean, 0.0)
    var = sum_views((per_view - mean[None]) ** 2) / (cnt[:, None] + 1e-8)
    var = torch.where(cnt[:, None] > 0, var, 1e6)
    return mean, torch.exp(-var), cnt


class NerfDetLegacy(nn.Module):
    """Single-scene legacy NeRF-Det forward, loss and predict.

    The constructor's fields are the JAX module's, with its defaults:
    ``n_samples`` samples on each of ``n_rand`` rays a step
    (nerfdet.py:89-90), the mapped features C / ``squeeze_scale`` wide
    (:96), the density-scaled volume (``nerf_density``), the ray mask on
    the colour loss (``use_nerf_mask``) and the depth L1
    (``depth_supervision``), and the networks' compute ``dtype`` (float32
    or bfloat16).
    """

    def __init__(self, cfg: ModelConfig, n_samples: int = 64,
                 n_rand: int = 2048, squeeze_scale: int = 4,
                 nerf_density: bool = True, use_nerf_mask: bool = True,
                 depth_supervision: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.head.with_yaw:
            raise ValueError("NeRF-Det has the axis-aligned head only, as "
                             "the JAX module does")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype float32 or bfloat16, not "
                             f"{dtype}")
        self.cfg = cfg
        self.dtype = dtype
        self.n_samples = n_samples
        self.n_rand = n_rand
        self.nerf_density = nerf_density
        self.use_nerf_mask = use_nerf_mask
        self.depth_supervision = depth_supervision
        c = cfg.backbone.fpn_out_channels
        self.nerf_feature_dim = c // squeeze_scale
        self.backbone = ResNet50(depth=cfg.backbone.depth,
                                 frozen_stages=cfg.backbone.frozen_stages,
                                 dtype=dtype)
        self.fpn = FPN(out_channels=c, dtype=dtype)
        self.neck3d = IndoorImVoxelNeck(in_channels=c,
                                        out_channels=cfg.neck3d_out_channels,
                                        dtype=dtype)
        self.head = DetectionHead(cfg.head,
                                  in_channels=cfg.neck3d_out_channels,
                                  dtype=dtype)
        # feature_dim = nerf_feature_dim + 6 == 2 * (dim / 2 + 3): the
        # mapped features and the rgb, their mean and exp(-var) halves
        # (nerfdet.py:101)
        self.nerf_mlp = VanillaNeRF(net_depth=4, net_width=256, skip_layer=3,
                                    feature_dim=self.nerf_feature_dim + 6,
                                    dtype=dtype)
        self.mapping = Linear(c, self.nerf_feature_dim // 2, dtype=dtype)

    # -- the rays' draws ---------------------------------------------------

    def draw_rays(self, batch: Dict[str, torch.Tensor],
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The branch's random draws from ``generator``, in this order:
        the rays' rows ``ys`` in [margin, Ht - margin), columns ``xs`` in
        [margin, Wt - margin) and targets ``ts`` in [0, T), then the (R, S)
        uniforms ``t`` that place each sample in its stratum; on the
        generator's device, then moved to the batch's."""
        t_cnt, ht, wt = batch["gt_images"].shape[:3]
        r, gdev = self.n_rand, generator.device
        draws = dict(
            ys=torch.randint(RAY_MARGIN, ht - RAY_MARGIN, (r,),
                             generator=generator, device=gdev),
            xs=torch.randint(RAY_MARGIN, wt - RAY_MARGIN, (r,),
                             generator=generator, device=gdev),
            ts=torch.randint(0, t_cnt, (r,), generator=generator, device=gdev),
            t=torch.rand((r, self.n_samples), generator=generator,
                         device=gdev))
        dev = batch["gt_images"].device
        return {k: v.to(dev) for k, v in draws.items()}

    # -- feature extraction ------------------------------------------------

    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, h, w, C) FPN level 0, channels-last,
        computed in the compute dtype and returned in float32 (`feats32`,
        mvsdet_tpu/models/nerfdet.py:135-138)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        feats = self.fpn(self.backbone(x))[0]
        return feats.permute(0, 2, 3, 1).to(torch.float32).contiguous()

    def extract_feat(self, batch: Dict[str, torch.Tensor], train: bool = False,
                     rays: Union[None, torch.Generator, Dict] = None) -> Dict:
        """Backbone -> backproject -> mean volume -> density scaling ->
        neck, and the NeRF branch where ``rays`` (a generator or
        `draw_rays`'s dict) is given and the batch holds render targets.
        ``train`` runs the neck's BatchNorm on batch statistics and updates
        its running ones.

        `batch` (one scene): images (N, H, W, 3) normalised; denorm_images
        (N, H, W, 3) in [0, 1]; w2c (N, 4, 4); intrinsic (4, 4) at image
        resolution; origin (3,); and for the branch gt_images (T, Ht, Wt,
        3), tgt_c2w (T, 4, 4), tgt_intrinsic (4, 4) at target resolution.
        """
        mc = self.cfg
        if batch["intrinsic"].ndim != 2 or (
                "tgt_intrinsic" in batch and batch["tgt_intrinsic"].ndim != 2):
            raise ValueError(SHARED_INTRINSICS)
        feats32 = self.image_features(batch["images"])
        c = feats32.shape[-1]
        proj34 = compute_projection(batch["w2c"], batch["intrinsic"],
                                    float(mc.feature_stride))
        points = voxel_points(mc.n_voxels, mc.voxel_size,
                              batch["origin"]).reshape(3, -1).T  # (V, 3)
        per_view, valid = simple_backproject(feats32, proj34, points)
        mean, _, cnt = mean_cov_volumes(per_view, valid)

        render = None
        if rays is not None and "gt_images" in batch:
            render = self.nerf_branch(batch, feats32, rays, train)

        volume = mean
        if self.nerf_density:
            # in predict too: the reference runs it whenever rays come
            # with the batch, which its test pipeline gives (nerfdet.py:
            # 281-318)
            alpha = self.voxel_density(batch, per_view, cnt, points)
            volume = torch.where(cnt[:, None] > 0, alpha[:, None] * mean, 0.0)

        nx, ny, nz = mc.n_voxels
        volume = volume.to(self.dtype).reshape(nx, ny, nz, c) \
            .permute(3, 0, 1, 2)[None]
        levels = self.neck3d(volume.contiguous(), train)
        return dict(levels=levels, valid_count=cnt.reshape(nx, ny, nz),
                    render=render)

    def nerf_branch(self, batch: Dict[str, torch.Tensor],
                    feats32: torch.Tensor,
                    rays: Union[torch.Generator, Dict],
                    train: bool) -> Dict[str, torch.Tensor]:
        """Image-mode NeRF supervision (`render_rays`, render_ray.py:
        231-305): ``n_rand`` rays over all targets, ``n_samples``
        stratified points each, sampled in every source view, pooled,
        through the NeRF MLP and composited.  The ray mask keeps the rays
        whose samples see more than one view more than 8 times
        (render_ray.py:214-216): with 8 samples or fewer it keeps none."""
        mc = self.cfg
        if isinstance(rays, torch.Generator):
            rays = self.draw_rays(batch, rays)
        ts, ys, xs = rays["ts"], rays["ys"], rays["xs"]
        r = ts.shape[0]
        pixel = torch.stack([xs, ys], dim=-1).to(torch.float32)
        tgt_c2w = batch["tgt_c2w"]
        dirs = pixel_ray_dirs(pixel, batch["tgt_intrinsic"][:3, :3],
                              tgt_c2w[ts, :3, :3])
        origins = tgt_c2w[ts, :3, 3]
        gt_rgb = batch["gt_images"][ts, ys, xs]                 # (R, 3)

        pts, z_vals = ray_render.sample_along_rays(
            rays["t"], origins, dirs, *mc.near_far_range, self.n_samples,
            det=not train)

        # multi-view rgb + mapped-feature aggregation
        feat_map = self.mapping(feats32)                      # (N, h, w, C/8)
        sampled, mask = ray_render.sample_views_at_points(
            pts.reshape(-1, 3), batch["denorm_images"], feat_map,
            batch["w2c"], batch["intrinsic"])
        mean_f, var_f = ray_render.masked_mean_var(sampled, mask)
        globalfeat = torch.cat([mean_f, var_f], dim=-1).reshape(
            r, self.n_samples, -1)
        view_count = mask.sum(dim=1).reshape(r, self.n_samples)

        rgb_pts, sigma = self.nerf_mlp(pts, dirs, globalfeat)
        out = ray_render.raw2outputs(rgb_pts, sigma[..., 0], z_vals)
        ray_mask = (view_count > 1).sum(dim=1) > 8
        return dict(rgb=out["rgb"], depth=out["depth"], gt_rgb=gt_rgb,
                    ray_mask=ray_mask, ray_ts=ts, ray_ys=ys, ray_xs=xs)

    def voxel_density(self, batch: Dict[str, torch.Tensor],
                      per_view: torch.Tensor, cnt: torch.Tensor,
                      points: torch.Tensor) -> torch.Tensor:
        """Alpha (V,) from the NeRF MLP's density at the voxel centres (the
        nerf_density path, nerfdet.py:281-318), in train and in predict.
        The RGB volume is backprojected at image resolution; the mapped
        feature volume is `mapping` of every view's row, an invalid view's
        zeroed row giving its bias.  Both are pooled over all N views by
        ``cnt``, the count of the features' backprojection (the RGB's
        validity may differ at the borders), as the reference pools them.
        """
        k = batch["intrinsic"][:3, :3]
        rgb_per_view, _ = simple_backproject(
            batch["denorm_images"].to(torch.float32),
            feinsum("ij,njk->nik", k, batch["w2c"][:, :3, :4]), points)
        mapped = torch.cat([rgb_per_view, self.mapping(per_view)], dim=-1)
        m_mean = sum_views(mapped) / (cnt[:, None] + 1e-8)
        m_var = sum_views((mapped - m_mean[None]) ** 2) / (cnt[:, None] + 1e-8)
        m_var = torch.where(cnt[:, None] > 0, m_var, 1e6)
        glob = torch.cat([m_mean, torch.exp(-m_var)], dim=-1)
        density = self.nerf_mlp.query_density(points, glob)[:, 0]
        return 1.0 - torch.exp(-density)

    # -- full forward ------------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                rays: Union[None, torch.Generator, Dict] = None) -> Dict:
        """Raw outputs (`NerfDetLegacy.__call__`); ``rays`` as
        `extract_feat` takes it."""
        out = self.extract_feat(batch, train, rays)
        head_outs = self.head(out["levels"])
        mc = self.cfg
        nx, ny, nz = mc.n_voxels
        sizes = [(nx >> i, ny >> i, nz >> i) for i in range(mc.head.n_levels)]
        pts = multiscale_voxel_points(sizes, mc.voxel_size, batch["origin"])
        valids = [_upsample_valid(out["valid_count"], s).reshape(-1)
                  for s in sizes]
        return dict(head_outs=head_outs, points=pts, valids=valids, **out)

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             rays: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Detection and NeRF losses (`NerfDet.loss`, nerfdet.py:327-405):
        the head's terms, `loss_nvs` (the colour MSE, over the masked rays
        with ``use_nerf_mask``) and, with ``depth_supervision`` and the
        targets' `gt_depth`, `loss_depth` (L1 where the depth is > 0).
        The rays come from ``generator`` or are ``rays`` (`draw_rays`'s
        dict), one of the two.  Runs the forward in train mode.

        Returns (total, aux): aux holds every term and `n_pos`.
        """
        if (generator is None) == (rays is None):
            raise ValueError("NeRF-Det's loss takes a generator or explicit "
                             "rays, one of the two")
        result = self(batch, train=True,
                      rays=generator if rays is None else rays)
        losses, aux = head_loss(
            result["head_outs"], result["points"], result["valids"],
            batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
            self.cfg.head)
        render = result["render"]
        if render is not None:
            diff = (render["rgb"] - render["gt_rgb"]) ** 2
            if self.use_nerf_mask:
                m = render["ray_mask"].to(torch.float32)
                losses["loss_nvs"] = (torch.sum(m[:, None] * diff)
                                      / (torch.sum(m) + 1e-6))
            else:
                losses["loss_nvs"] = torch.mean(diff)
            if self.depth_supervision and "gt_depth" in batch:
                gt_d = batch["gt_depth"][render["ray_ts"], render["ray_ys"],
                                         render["ray_xs"]]
                dm = (gt_d > 0).to(torch.float32)
                losses["loss_depth"] = (
                    torch.sum(dm * torch.abs(render["depth"] - gt_d))
                    / (torch.sum(dm) + 1e-6))
        total = sum(losses.values())
        aux.update(losses)
        return total, aux

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """NMS'd boxes, scores, labels and mask (`NerfDetLegacy.predict`):
        no rendered view and no depth expectation."""
        result = self(batch, train=False)
        return head_predict(result["head_outs"], result["points"],
                            result["valids"], self.cfg.head)
