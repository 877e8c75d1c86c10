"""`benchmark/flops.py` against a count by hand at `tiny_test_config()`
(32x48 images, 8x12 features, 4 planes, 8x8x4 voxels, 5 classes)."""

from __future__ import annotations

from benchmark.flops import scene_flops
from benchmark.reference.config import tiny_test_config


def conv(out_spatial: int, c_in: int, c_out: int, taps: int) -> int:
    return 2 * out_spatial * c_in * c_out * taps


def deconv(in_spatial: int, c_in: int, c_out: int, taps: int) -> int:
    return 2 * in_spatial * c_in * c_out * taps


def backbone_fpn(n: int) -> int:
    f = conv(16 * 24, 3, 64, 49)                          # stem, 7x7 s2
    res = {1: 8 * 12, 2: 4 * 6, 3: 2 * 3, 4: 1 * 2}       # stage outputs
    in_ch, in_res = 64, res[1]
    for stage, blocks in zip((1, 2, 3, 4), (3, 4, 6, 3)):
        width = 64 * 2 ** (stage - 1)
        for b in range(blocks):
            out_res = res[stage]
            f += conv(in_res, in_ch, width, 1)            # conv1 at input
            f += conv(out_res, width, width, 9)           # conv2 (stride)
            f += conv(out_res, width, 4 * width, 1)       # conv3
            if b == 0:
                f += conv(out_res, in_ch, 4 * width, 1)   # downsample
            in_ch, in_res = 4 * width, out_res
    for c, r in zip((256, 512, 1024, 2048), res.values()):
        f += conv(r, c, 256, 1)                           # laterals
    f += conv(8 * 12, 256, 256, 9)                        # out0 only
    return n * f


def cost_reg(n: int) -> int:
    full, half, quarter = 4 * 8 * 12, 2 * 4 * 6, 1 * 2 * 3
    f = (conv(full, 256, 64, 27) + conv(half, 64, 128, 27)
         + conv(half, 128, 128, 27) + conv(quarter, 128, 256, 27)
         + conv(quarter, 256, 256, 27) + deconv(quarter, 256, 128, 27)
         + deconv(half, 128, 64, 27) + conv(full, 64, 2, 27))
    return n * f


def neck_head() -> int:
    v0, v1, v2 = 8 * 8 * 4, 4 * 4 * 2, 2 * 2 * 1
    f = conv(v0, 256, 256, 27) * 2                        # down0
    f += conv(v1, 256, 512, 27) + conv(v1, 512, 512, 27) \
        + conv(v1, 256, 512, 1)                           # down1
    f += conv(v2, 512, 1024, 27) + conv(v2, 1024, 1024, 27) \
        + conv(v2, 512, 1024, 1)                          # down2
    f += conv(v2, 1024, 128, 27)                          # out2
    f += deconv(v2, 1024, 512, 8) + conv(v1, 512, 512, 27) \
        + conv(v1, 512, 128, 27)                          # up2, out1
    f += deconv(v1, 512, 256, 8) + conv(v0, 256, 256, 27) \
        + conv(v0, 256, 128, 27)                          # up1, out0
    f += sum(conv(v, 128, 1 + 6 + 5, 27) for v in (v0, v1, v2))  # head
    return f


def test_predict_forward_by_hand():
    n, targets = 5, 1
    got = scene_flops(tiny_test_config(), n, targets, train=False)
    assert got["backbone_fpn"] == backbone_fpn(n)
    assert got["cost_reg"] == cost_reg(n)
    assert got["neck_head"] == neck_head()
    # 3 nearest source views of one target, 96 pixels, 260 -> 21
    assert got["gaussian_head"] == 2 * 3 * 96 * 260 * 21
    # 2 neighbours: 8 FLOPs a warped value, 3 a view and 3 for the variance
    assert got["plane_sweep"] == n * 4 * 96 * 256 * (2 * 8 + 3 * 3 + 3)
    assert got["voxel_lift"] == 2 * 256 * n * 256
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


def test_training_step_counts_backward_where_it_runs():
    n, targets = 5, 2
    fwd = scene_flops(tiny_test_config(), n, targets, train=False)
    step = scene_flops(tiny_test_config(), n, targets, train=True)
    # every CostRegNet and neck layer trains and its input needs a
    # gradient: data and weight gradients, each a forward's worth
    assert step["cost_reg"] == 3 * fwd["cost_reg"]
    assert step["neck_head"] == 3 * fwd["neck_head"]
    # the stem and layer1 are frozen and detached: no backward there
    frozen = conv(16 * 24, 3, 64, 49) * n
    assert fwd["backbone_fpn"] < step["backbone_fpn"] \
        < 3 * fwd["backbone_fpn"] - 2 * frozen
    assert step["plane_sweep"] == 2 * fwd["plane_sweep"]
    assert step["voxel_lift"] == 3 * fwd["voxel_lift"]
