"""The FLOPs one scene of MVSDet requires, from its configuration's
shapes: the numerator of `mfu.train` and `mfu.predict`.

The convolutions and dense layers are counted by torch's `FlopCounterMode`
(2 per multiply-add) over the reference's modules on the `meta` device:
shapes only, no data.  Backward counts what autograd must do with the
frozen stem and layer1 detached: a data gradient where a layer's input
needs one, a weight gradient where the layer trains; no checkpoint
recompute.  What is not a product of weights is counted by hand, the
same whatever implements it:

  plane sweep  per neighbour, plane, pixel and channel the bilinear
               warp's 4 taps (8 FLOPs), and per plane, pixel and channel
               the variance over k + 1 views (3 per view + 3); backward
               the same again (a data gradient only);
  voxel lift   2C per (view, voxel) pair forward, and 2C each for the
               feature and the weight gradient.

Left out, each well under 0.1% of a step: the depth softmax and top-k,
the Gaussian adapter, the splatting, the losses and the AdamW update.
FPN levels 1-3 are computed by the port but consumed by nothing, so their
output convolutions are not required and not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models.mvsdet import MVSDet
from benchmark.reference.ops.sampling import nearest_resize

WARP_FLOPS = 8          # 4 bilinear taps, a multiply and an add each


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def scene_flops(cfg, n_views: int, n_targets: int, train: bool) -> dict:
    """FLOPs of one scene by part (and `total`): the training step's
    forward and backward with ``train``, predict's forward otherwise.
    ``cfg`` is the reference's `Config`."""
    mc = cfg.model
    with torch.device("meta"):
        model = MVSDet(mc)
    model.train(train)
    grad = torch.enable_grad() if train else torch.no_grad()
    h, w = mc.image_size
    fh, fw = mc.feature_size
    c = mc.backbone.fpn_out_channels
    d = mc.gs.num_depth_planes
    k = min(mc.plane_sweep_neighbors, n_views - 1)
    meta = dict(device="meta")
    out = {}

    def backbone_fpn():
        images = torch.empty(n_views, 3, h, w, **meta)
        feats = model.backbone(images)
        lat = [getattr(model.fpn, f"lateral{i}")(x)
               for i, x in enumerate(feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + nearest_resize(
                lat[i], lat[i - 1].shape[2:], (2, 3))
        y = model.fpn.out0(lat[0])
        if train:
            y.sum().backward()

    def cost_reg():
        var = torch.empty(n_views, c, d, fh, fw, requires_grad=train,
                          **meta)
        y = model.cost_reg(var, train)
        if train:
            y.sum().backward()

    def neck_head():
        nx, ny, nz = mc.n_voxels
        vol = torch.empty(1, c, nx, ny, nz, requires_grad=train, **meta)
        outs = model.head(model.neck3d(vol, train))
        if train:
            sum(t.sum() for level in outs for t in level).backward()

    def gaussians():
        s = n_targets * min(mc.gs.render_src_per_target, n_views - 1)
        x = torch.empty(s, fh * fw, c + 1 + 3 * mc.gs.use_rgb_gaussian,
                        requires_grad=train, **meta)
        y = model.to_gaussians(x)
        if train:
            y.sum().backward()

    with grad:
        out["backbone_fpn"] = _counted(backbone_fpn)
        out["cost_reg"] = _counted(cost_reg)
        out["neck_head"] = _counted(neck_head)
        out["gaussian_head"] = _counted(gaussians)
    passes = 2 if train else 1
    out["plane_sweep"] = passes * n_views * d * fh * fw * c * (
        k * WARP_FLOPS + 3 * (k + 1) + 3)
    n_vox = mc.n_voxels[0] * mc.n_voxels[1] * mc.n_voxels[2]
    out["voxel_lift"] = (3 if train else 1) * 2 * c * n_views * n_vox
    out["total"] = sum(out.values())
    return out
