"""The port's CUDA kernels, its predict path and its training step on the
card.

Every test here needs an NVIDIA card and nvcc and skips without them.
The file imports neither JAX nor the JAX package, so it runs where the
card is, without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from mvsdet_torch.config import tiny_test_config
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.models.mvsdet import build_model
from mvsdet_torch.ops import nms
from mvsdet_torch.ops.lift_kernel import (
    lift_rows, lift_rows_reference, weighted_gather_sum,
    weighted_gather_sum_dfeat, weighted_gather_sum_dfeat_reference,
    weighted_gather_sum_dfeat_rows_reference, weighted_gather_sum_dweight,
    weighted_gather_sum_dweight_reference, weighted_gather_sum_reference)
from mvsdet_torch.ops.splat_kernel import (
    ALPHA_MIN, KERNEL_CONSTANTS, _bwd_library, _fwd_library, _pairs,
    _tile_pixel_coords, composite_tiles, composite_tiles_bwd,
    composite_tiles_bwd_reference, composite_tiles_reference, cull_boxes,
    cull_boxes_reference, kernel_constants)
from mvsdet_torch.training.loop import create_train_state, make_train_step

from _lift_cases import lift_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tables(n_tiles, k, c, tiles_x, seed=0, kind="random"):
    """Tile tables in the compositor's layout, 30% of slots empty.

    kind "culled_tile": every slot of tile 0 empty and every slot of tile 1
    below the opacity cutoff; "non_pd": a quarter of the slots with a conic
    that is not positive definite (a < 0, or b^2 > a c) and a few nearly
    singular ones."""
    rng = np.random.RandomState(seed)
    data = np.zeros((n_tiles, 8, k), np.float32)
    data[:, 0] = rng.uniform(-8, tiles_x * 16 + 8, (n_tiles, k))
    data[:, 1] = rng.uniform(-8, n_tiles // tiles_x * 16 + 8, (n_tiles, k))
    data[:, 2] = rng.uniform(0.02, 0.5, (n_tiles, k))
    data[:, 3] = rng.uniform(-0.02, 0.02, (n_tiles, k))
    data[:, 4] = rng.uniform(0.02, 0.5, (n_tiles, k))
    data[:, 5] = rng.uniform(0, 0.95, (n_tiles, k)) * (rng.rand(n_tiles, k)
                                                        >= 0.3)
    if kind == "culled_tile":
        data[0, 5] = 0.0
        data[1, 5] = rng.uniform(0, 1 / 256, k)
    elif kind == "non_pd":
        pick = rng.rand(n_tiles, k)
        data[:, 2] = np.where(pick < 0.1, -data[:, 2], data[:, 2])
        root = np.sqrt(np.abs(data[:, 2] * data[:, 4]))
        data[:, 3] = np.where((pick >= 0.1) & (pick < 0.25), 1.5 * root,
                              data[:, 3])
        data[:, 3] = np.where((pick >= 0.25) & (pick < 0.3), 0.9999 * root,
                              data[:, 3])
    vals = rng.rand(n_tiles, c, k).astype(np.float32)
    return torch.from_numpy(data), torch.from_numpy(vals)


# the kernels run one CTA per 128-slot segment of a tile
COMPOSITOR_CASES = [
    (24, 512, 3, 4, "random"),        # two stacked 4x3-tile views
    (10, 300, 1, 5, "random"),        # a ragged last segment of 44 slots
    (6, 2048, 4, 3, "random"),        # the step's capacity, four channels
    (4, 100, 2, 2, "random"),         # K below one segment
    (6, 600, 3, 3, "culled_tile"),    # tiles whose slots are all culled
    (6, 512, 2, 2, "non_pd"),         # conics that are not positive definite
    (4, 256, 1, 2, "non_pd"),         # two whole segments, one channel
    (4, 777, 4, 4, "random"),         # four channels, ragged
]


@pytest.mark.parametrize("n_tiles,k,c,tiles_x,kind", COMPOSITOR_CASES)
def test_compositor_matches_plain_version(cuda, n_tiles, k, c, tiles_x,
                                          kind):
    data, vals = (t.to(cuda) for t in tables(n_tiles, k, c, tiles_x,
                                             kind=kind))
    launches = composite_tiles.launches
    got = composite_tiles(data, vals, tiles_x)
    torch.cuda.synchronize()
    assert composite_tiles.launches == launches + 1
    torch.testing.assert_close(
        got, composite_tiles_reference(data, vals, tiles_x), atol=1e-5,
        rtol=1e-5)


@pytest.mark.parametrize("n,hw,c,v", [(5, 40, 264, 70), (3, 12, 8, 9)])
def test_gather_is_bit_equal_to_plain_version(cuda, n, hw, c, v):
    rng = np.random.RandomState(c)
    feat = torch.from_numpy(rng.rand(n, hw, c).astype(np.float32))
    pix = torch.from_numpy(rng.randint(0, hw, (n, v)).astype(np.int32))
    weight = torch.from_numpy((rng.rand(n, v) * (rng.rand(n, v) < 0.6))
                              .astype(np.float32))
    args = [t.to(cuda) for t in (feat, pix, weight)]
    launches = weighted_gather_sum.launches
    got = weighted_gather_sum(*args)
    torch.cuda.synchronize()
    assert weighted_gather_sum.launches == launches + 1
    assert torch.equal(got, weighted_gather_sum_reference(*args))


@pytest.mark.parametrize("kind", ["uniform", "clipped", "single_row",
                                  "zero_weight", "sparse_rows", "dense"])
@pytest.mark.parametrize("n", [1, 33, 40, 97])
@pytest.mark.parametrize("c", [4, 12, 264, 512])
def test_gather_on_layouts(cuda, kind, n, c):
    """K3 in both dtypes on the lift's layouts: N within one 64-view
    staging chunk and past it, V = 1001 voxels (not a multiple of the
    4-voxel tile), C of one load a lane, of 8-byte bf16 loads, and of a
    ragged or whole second channel block.  Bit-equal to the plain version
    and to a second launch; bf16 bit-equal to the float32 kernel on the
    widened rows."""
    feat, pix, weight, _ = (torch.from_numpy(a).to(cuda) for a in
                            lift_case(kind, n, 300, c, 1001, seed=n + c))
    for rows in (feat, feat.to(torch.bfloat16)):
        got = weighted_gather_sum(rows, pix, weight)
        assert torch.equal(got, weighted_gather_sum_reference(rows, pix,
                                                              weight))
        assert torch.equal(got, weighted_gather_sum(rows, pix, weight))
    assert torch.equal(got, weighted_gather_sum(rows.float(), pix, weight))
    if kind == "zero_weight":
        assert not got.any()


def _backward_inputs(n_tiles, k, c, tiles_x, kind, device):
    data, vals = tables(n_tiles, k, c, tiles_x, seed=k, kind=kind)
    if kind == "culled_tile":              # clipped, but culled tiles stay so
        head = data[:, 5, :k // 10]
        data[:, 5, :k // 10] = torch.where(head >= 1 / 255, 1.3, head)
    else:
        data[:, 5, :k // 10] = 1.3                      # clipped at 0.99
    g = torch.from_numpy(np.random.RandomState(c).randn(
        n_tiles, c + 1, 256).astype(np.float32))       # g_T != 0
    return tuple(t.to(device) for t in (data, vals, g))


@pytest.mark.parametrize("n_tiles,k,c,tiles_x,kind", COMPOSITOR_CASES)
def test_compositor_backward_matches_plain_version(cuda, n_tiles, k, c,
                                                   tiles_x, kind):
    data, vals, g = _backward_inputs(n_tiles, k, c, tiles_x, kind, cuda)
    launches = composite_tiles_bwd.launches
    got = composite_tiles_bwd(data, vals, g, tiles_x)
    torch.cuda.synchronize()
    assert composite_tiles_bwd.launches == launches + 1
    for a, b in zip(got, composite_tiles_bwd_reference(data, vals, g,
                                                       tiles_x)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    assert torch.all(got[0][:, 6:] == 0)
    if kind == "culled_tile":
        assert torch.all(got[0][:2] == 0) and torch.all(got[1][:2] == 0)


@pytest.mark.parametrize("n_tiles,k,c,tiles_x,kind", [
    (24, 512, 3, 4, "random"), (10, 300, 1, 5, "non_pd"),
    (6, 2048, 4, 3, "random")])
def test_compositor_launches_are_bit_equal(cuda, n_tiles, k, c, tiles_x,
                                           kind):
    """No atomics and a fixed order of every sum: two launches on the same
    inputs give the same bits, forward and backward."""
    data, vals, g = _backward_inputs(n_tiles, k, c, tiles_x, kind, cuda)
    assert torch.equal(composite_tiles(data, vals, tiles_x),
                       composite_tiles(data, vals, tiles_x))
    first = composite_tiles_bwd(data, vals, g, tiles_x)
    second = composite_tiles_bwd(data, vals, g, tiles_x)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def stress_tables(n_tiles, k, tiles_x, seed):
    """Tables that probe the cull box's edge: opacities log-uniform from
    just below 1/255 to clipped, conic scales over five decades, means
    near integer pixel positions, correlations up to |b| = 0.999 sqrt(ac),
    plus empty slots, conics that are not positive definite and nearly
    singular ones."""
    rng = np.random.RandomState(seed)
    shape = (n_tiles, k)
    data = np.zeros((n_tiles, 8, k), np.float32)
    data[:, 0] = np.round(rng.uniform(-20, tiles_x * 16 + 20, shape)) \
        + rng.choice([0.0, 0.5, 1e-3, -1e-3], shape)
    data[:, 1] = np.round(rng.uniform(-20, n_tiles // tiles_x * 16 + 20,
                                      shape)) \
        + rng.choice([0.0, 0.5, 1e-3, -1e-3], shape)
    a = 10.0 ** rng.uniform(-4, 1, shape)
    cc = 10.0 ** rng.uniform(-4, 1, shape)
    rho = rng.choice([0.0, 0.5, -0.9, 0.999, -0.999], shape) \
        * rng.uniform(0, 1, shape)
    pick = rng.rand(*shape)
    rho = np.where(pick < 0.05, 1.2, rho)                    # det < 0
    a = np.where((pick >= 0.05) & (pick < 0.1), -a, a)       # a < 0
    rho = np.where((pick >= 0.1) & (pick < 0.12), 0.99999, rho)
    data[:, 2] = a
    data[:, 3] = rho * np.sqrt(np.abs(a * cc))
    data[:, 4] = cc
    op = 10.0 ** rng.uniform(np.log10(ALPHA_MIN) - 0.01, 0.2, shape)
    op = np.where(rng.rand(*shape) < 0.1, ALPHA_MIN * (1 + 1e-6), op)
    # a fifth of the slots sit on the box's edge: an axis-aligned splat at
    # an integer mean whose alpha at n pixels along x or y is 1/255 to
    # within a few float steps, so the exact ellipse passes through pixels
    edge = rng.rand(*shape) < 0.2
    n = rng.randint(1, 12, shape).astype(np.float64)
    along_x = rng.rand(*shape) < 0.5
    curv = np.where(along_x, np.abs(a), cc)
    op = np.where(edge, np.float32(ALPHA_MIN) * np.exp(0.5 * curv * n * n)
                  * (1 + rng.choice([-1e-6, 0.0, 1e-7, 1e-6], shape)), op)
    data[:, 0] = np.where(edge, np.round(data[:, 0]), data[:, 0])
    data[:, 1] = np.where(edge, np.round(data[:, 1]), data[:, 1])
    data[:, 2] = np.where(edge, np.abs(a), data[:, 2])
    data[:, 3] = np.where(edge, 0.0, data[:, 3])
    data[:, 5] = np.minimum(op, 2.0) * (rng.rand(*shape) >= 0.2)
    return data


def pairs_outside_box(data, tiles_x):
    """Active pairs of the plain compositor outside the cull of `data`'s
    device (the kernels' own on the card, `cull_boxes_reference` on the
    CPU), the active pairs, and the share of pairs inside a kept box."""
    keep, box = cull_boxes(data)
    active = _pairs(data, tiles_x)[5]                        # (T, P, K)
    px, py = _tile_pixel_coords(data.shape[0], tiles_x, data.device)
    x, y = px[..., None], py[..., None]
    b = box[:, :, None, :]
    inside = keep[:, None, :] & (x >= b[:, 0]) & (x <= b[:, 1]) \
        & (y >= b[:, 2]) & (y <= b[:, 3])
    return (int((active & ~inside).sum()), int(active.sum()),
            float(inside.float().mean()))


def test_kernels_carry_the_plain_versions_constants(cuda):
    """The segment size and the cull's slack that the plain versions copy
    are the ones each compositor library was built with."""
    for lib in (_fwd_library(), _bwd_library()):
        assert kernel_constants(lib) == KERNEL_CONSTANTS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_cull_boxes_hold_every_active_pair(cuda, seed):
    """The kernels' own boxes on the box-edge tables: no active pair
    outside, and the boxes of `cull_boxes_reference` to float rounding."""
    data = torch.from_numpy(stress_tables(12, 512, 4, seed)).to(cuda)
    outside, active, in_box = pairs_outside_box(data, 4)
    assert outside == 0 and active > 1000 and in_box < 0.5
    keep, box = cull_boxes(data)
    want_keep, want_box = cull_boxes_reference(data)
    assert torch.equal(keep, want_keep)
    k = keep[:, None].expand_as(box)
    torch.testing.assert_close(box[k], want_box[k], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_compositor_on_box_edge_tables(cuda, seed):
    """K1 and K2 against their plain versions on the box-edge tables.  A
    skipped active pair (alpha >= 1/255) would move a pixel's final
    transmittance by 1/255 of itself or more, so T_final is held to 1e-4
    relative (every pixel's T_final is far above underflow here)."""
    n_tiles, k, c, tiles_x = 12, 512, 3, 4
    data = torch.from_numpy(stress_tables(n_tiles, k, tiles_x, seed))
    rng = np.random.RandomState(seed)
    vals = torch.from_numpy(rng.rand(n_tiles, c, k).astype(np.float32))
    g = torch.from_numpy(rng.randn(n_tiles, c + 1, 256).astype(np.float32))
    data, vals, g = (t.to(cuda) for t in (data, vals, g))
    got = composite_tiles(data, vals, tiles_x)
    want = composite_tiles_reference(data, vals, tiles_x)
    assert want[:, c].min() > 1e-20
    assert ((got[:, c] - want[:, c]).abs() / want[:, c]).max() <= 1e-4
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for a, b in zip(composite_tiles_bwd(data, vals, g, tiles_x),
                    composite_tiles_bwd_reference(data, vals, g, tiles_x)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("n,hw,c,v", [(5, 40, 264, 70), (3, 12, 8, 9)])
def test_gather_backward_matches_plain_versions(cuda, n, hw, c, v):
    rng = np.random.RandomState(c)
    feat, pix, weight, g = (torch.from_numpy(a).to(cuda) for a in (
        rng.rand(n, hw, c).astype(np.float32),
        rng.randint(0, hw, (n, v)).astype(np.int32),
        (rng.rand(n, v) * (rng.rand(n, v) < 0.6)).astype(np.float32),
        rng.randn(v, c).astype(np.float32)))
    launches = (weighted_gather_sum_dfeat.launches,
                weighted_gather_sum_dweight.launches)
    dfeat = weighted_gather_sum_dfeat(pix, weight, g, hw)
    dw = weighted_gather_sum_dweight(feat, pix, g)
    torch.cuda.synchronize()
    assert (weighted_gather_sum_dfeat.launches,
            weighted_gather_sum_dweight.launches) == (launches[0] + 1,
                                                      launches[1] + 1)
    want = weighted_gather_sum_dfeat_reference(pix, weight, g, hw)
    assert (dfeat - want).abs().max() <= 1e-5 * want.abs().max()
    want = weighted_gather_sum_dweight_reference(feat, pix, g)
    assert (dw - want).abs().max() <= 1e-5 * want.abs().max()


# the index kernel runs one CTA per (view, 1024 rows)
LIFT_CASES = [
    ("uniform", 5, 40, 264, 70),          # C above 256: three float4 a lane
    ("uniform", 3, 12, 8, 9),             # fewer pairs than a warp
    ("clipped", 4, 4800, 256, 25600),     # the step's views
    ("single_row", 2, 4800, 256, 25600),  # a view's 25,600 pairs on one row
    ("zero_weight", 3, 300, 64, 2000),
    ("sparse_rows", 3, 5000, 32, 700),    # five chunks, most rows empty
]


@pytest.mark.parametrize("kind,n,hw,c,v", LIFT_CASES)
def test_lift_backward_kernels_on_layouts(cuda, kind, n, hw, c, v):
    """The row index equals its plain version; K4 is bit-equal to its plain
    version in its own order and to a second launch; K4 and K5 within
    1e-5 of max |plain|."""
    feat, pix, weight, g = (torch.from_numpy(a).to(cuda)
                            for a in lift_case(kind, n, hw, c, v))
    rows = lift_rows(pix, hw)
    for got, want in zip(rows, lift_rows_reference(pix, hw)):
        assert torch.equal(got, want)
    dfeat = weighted_gather_sum_dfeat(pix, weight, g, hw, rows)
    assert torch.equal(dfeat, weighted_gather_sum_dfeat(pix, weight, g, hw))
    assert torch.equal(dfeat, weighted_gather_sum_dfeat_rows_reference(
        rows, weight, g, hw))
    want = weighted_gather_sum_dfeat_reference(pix, weight, g, hw)
    assert (dfeat - want).abs().max() <= 1e-5 * want.abs().max()
    if kind == "zero_weight":
        assert not dfeat.any()
    loads = torch.zeros(1, dtype=torch.int32, device=cuda)
    dw = weighted_gather_sum_dweight(feat, pix, g, rows, loads)
    want = weighted_gather_sum_dweight_reference(feat, pix, g)
    assert (dw - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(dw, weighted_gather_sum_dweight(feat, pix, g))
    # K5 loads each row its pairs select at least once, and at most once a
    # pair; a view's pairs on one row are read once per run, not per pair
    selected = torch.unique(torch.arange(n, device=cuda)[:, None] * hw
                            + pix.long()).numel()
    assert selected <= int(loads) <= n * v
    if kind == "single_row":
        assert int(loads) * 16 <= n * v


def test_lift_backward_refuses_what_the_kernels_do_not_take(cuda):
    pix = torch.zeros(2, 5, dtype=torch.int32, device=cuda)
    w = torch.zeros(2, 5, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        weighted_gather_sum_dfeat(pix, w, torch.zeros(5, 6, device=cuda), 6)
    with pytest.raises(ValueError, match="multiple of 4"):
        weighted_gather_sum_dweight(torch.zeros(2, 6, 6, device=cuda), pix,
                                    torch.zeros(5, 6, device=cuda))
    with pytest.raises(ValueError, match="512"):
        weighted_gather_sum_dfeat(pix, w, torch.zeros(5, 516, device=cuda),
                                  6)
    with pytest.raises(ValueError, match="int32"):
        weighted_gather_sum_dfeat(pix, w, torch.zeros(5, 8, device=cuda),
                                  2**30)
    with pytest.raises(ValueError, match="int32"):
        lift_rows(torch.zeros(1, 1, dtype=torch.int32, device=cuda)
                  .expand(2, 2**30), 4)
    with pytest.raises(ValueError, match="row_loads"):
        weighted_gather_sum_dweight(torch.zeros(2, 6, 8, device=cuda), pix,
                                    torch.zeros(5, 8, device=cuda), None,
                                    torch.zeros(1, device=cuda))
    with pytest.raises(ValueError, match=r"\[0, 6\)"):
        lift_rows(torch.full((2, 5), 6, dtype=torch.int32, device=cuda), 6,
                  check=True)


def test_gradients_run_the_backward_kernels(cuda):
    data, vals = (t.to(cuda).requires_grad_(True)
                  for t in tables(4, 64, 3, 2))
    before = (composite_tiles.launches, composite_tiles_bwd.launches)
    composite_tiles(data, vals, 2).sum().backward()
    assert (composite_tiles.launches, composite_tiles_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    feat = torch.rand(2, 6, 4, device=cuda, requires_grad=True)
    w = torch.rand(2, 5, device=cuda, requires_grad=True)
    pix = torch.randint(0, 6, (2, 5), dtype=torch.int32, device=cuda)
    counted = (weighted_gather_sum, weighted_gather_sum_dfeat,
               weighted_gather_sum_dweight, lift_rows)
    before = [k.launches for k in counted]
    weighted_gather_sum(feat, pix, w).sum().backward()
    assert [k.launches for k in counted] == [b + 1 for b in before]
    assert feat.grad is not None and w.grad is not None


def test_gather_refuses_a_misaligned_feature_map(cuda):
    feat = torch.zeros(2 * 6 * 4 + 1, device=cuda)[1:].reshape(2, 6, 4)
    with pytest.raises(ValueError, match="16-byte"):
        weighted_gather_sum(feat, torch.zeros(2, 5, dtype=torch.int32,
                                              device=cuda),
                            torch.zeros(2, 5, device=cuda))


def within_bf16_rounding(got, want):
    """got (bf16) within one bf16 ulp of want (float32, summed in another
    order): 2^-7 of the value, plus 1e-5 of the largest where the sums
    cancel."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs()
                 + 1e-5 * want.abs().max()).all())


@pytest.mark.parametrize("n,hw,c,v", [(5, 40, 264, 70), (3, 12, 12, 9),
                                      (2, 30, 516, 40)])
def test_bf16_gather_is_bit_equal_to_plain_version(cuda, n, hw, c, v):
    """The bf16-feature K3, 16-byte row loads (C % 8 == 0) and 8-byte ones
    (C = 12), bit-equal to its plain version and to the float32 kernel on
    the widened rows."""
    rng = np.random.RandomState(c)
    feat = torch.from_numpy(rng.rand(n, hw, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    pix = torch.from_numpy(rng.randint(0, hw, (n, v)).astype(np.int32)).to(
        cuda)
    weight = torch.from_numpy((rng.rand(n, v) * (rng.rand(n, v) < 0.6))
                              .astype(np.float32)).to(cuda)
    launches = (weighted_gather_sum.launches,
                weighted_gather_sum.bf16_launches)
    got = weighted_gather_sum(feat, pix, weight)
    torch.cuda.synchronize()
    assert (weighted_gather_sum.launches,
            weighted_gather_sum.bf16_launches) == (launches[0] + 1,
                                                   launches[1] + 1)
    assert got.dtype == torch.float32
    assert torch.equal(got, weighted_gather_sum_reference(feat, pix, weight))
    assert torch.equal(got, weighted_gather_sum(feat.float(), pix, weight))


@pytest.mark.parametrize("kind,n,hw,c,v", LIFT_CASES)
def test_bf16_lift_kernels_on_layouts(cuda, kind, n, hw, c, v):
    """The bf16 variants of K4 and K5: K4's bf16 d-feat bit-equal to its
    plain version in its own order (the float32 sum rounded once) and to
    a second launch, within one bf16 ulp of the float32 index_add_ plain
    version;
    K5 on bf16 rows within 1e-5 of max |plain| and bit-equal to the
    float32 kernel on the widened rows."""
    feat, pix, weight, g = (torch.from_numpy(a).to(cuda)
                            for a in lift_case(kind, n, hw, c, v))
    bf16 = torch.bfloat16
    feat = feat.to(bf16)
    kernels = (weighted_gather_sum_dfeat, weighted_gather_sum_dweight)
    before = [k.bf16_launches for k in kernels]
    rows = lift_rows(pix, hw)
    dfeat = weighted_gather_sum_dfeat(pix, weight, g, hw, rows, bf16)
    dw = weighted_gather_sum_dweight(feat, pix, g, rows)
    torch.cuda.synchronize()
    assert [k.bf16_launches for k in kernels] == [b + 1 for b in before]
    assert dfeat.dtype == bf16 and dw.dtype == torch.float32
    assert torch.equal(dfeat, weighted_gather_sum_dfeat(pix, weight, g, hw,
                                                        None, bf16))
    assert torch.equal(dfeat, weighted_gather_sum_dfeat_rows_reference(
        rows, weight, g, hw, bf16))
    assert within_bf16_rounding(dfeat, weighted_gather_sum_dfeat_reference(
        pix, weight, g, hw))
    if kind == "zero_weight":
        assert not dfeat.any()
    want = weighted_gather_sum_dweight_reference(feat, pix, g)
    assert (dw - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(dw, weighted_gather_sum_dweight(feat.float(), pix, g,
                                                       rows))


def test_bf16_lift_refuses_other_dtypes_and_misaligned_rows(cuda):
    pix = torch.zeros(2, 5, dtype=torch.int32, device=cuda)
    w = torch.zeros(2, 5, device=cuda)
    g = torch.zeros(5, 8, device=cuda)
    for dtype in (torch.float16, torch.float64):
        feat = torch.zeros(2, 6, 8, dtype=dtype, device=cuda)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            weighted_gather_sum(feat, pix, w)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            weighted_gather_sum_dweight(feat, pix, g)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            weighted_gather_sum_dfeat(pix, w, g, 6, None, dtype)
    with pytest.raises(TypeError, match="float32 g"):
        weighted_gather_sum_dweight(torch.zeros(2, 6, 8, dtype=torch.bfloat16,
                                                device=cuda), pix,
                                    g.to(torch.bfloat16))
    # rows of 6 bf16 channels do not start on 8-byte boundaries
    odd = torch.zeros(2, 6, 6, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        weighted_gather_sum(odd, pix, w)
    with pytest.raises(ValueError, match="multiple of 4"):
        weighted_gather_sum_dweight(odd, pix, torch.zeros(5, 6, device=cuda))
    shifted = torch.zeros(2 * 6 * 8 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].reshape(2, 6, 8)
    with pytest.raises(ValueError, match="16-byte"):
        weighted_gather_sum(shifted, pix, w)
    with pytest.raises(ValueError, match="16-byte"):
        weighted_gather_sum_dweight(shifted, pix, g)


def test_bf16_gradients_run_the_bf16_backward_kernels(cuda):
    """One backward of the autograd Function with bf16 rows: the bf16 K3,
    the index, the bf16 K4 and K5, once each; a bf16 d-feat and a float32
    d-weight, against the plain backward on the CPU (d-feat within one
    bf16 ulp of the float32 sum: the two sum in other orders)."""
    rng = np.random.RandomState(0)
    feat = torch.from_numpy(rng.rand(3, 40, 16).astype(np.float32)).to(
        torch.bfloat16)
    pix = torch.from_numpy(rng.randint(0, 40, (3, 30)).astype(np.int32))
    w = torch.from_numpy(rng.rand(3, 30).astype(np.float32))
    g = torch.from_numpy(rng.randn(30, 16).astype(np.float32))
    grads = {}
    counted = (weighted_gather_sum, weighted_gather_sum_dfeat,
               weighted_gather_sum_dweight)
    for dev in ("cpu", cuda):
        f = feat.to(dev).detach().requires_grad_(True)
        ww = w.to(dev).detach().requires_grad_(True)
        before = [k.bf16_launches for k in counted] + [lift_rows.launches]
        out = weighted_gather_sum(f, pix.to(dev), ww)
        assert out.dtype == torch.float32
        out.backward(g.to(dev))
        after = [k.bf16_launches for k in counted] + [lift_rows.launches]
        assert after == ([b + 1 for b in before] if dev == cuda
                         else before), dev
        assert f.grad.dtype == torch.bfloat16 and ww.grad.dtype == \
            torch.float32
        grads[str(dev)] = (f.grad.cpu(), ww.grad.cpu())
    (df_c, dw_c), (df_g, dw_g) = grads["cpu"], grads["cuda"]
    want = weighted_gather_sum_dfeat_reference(pix, w, g, 40)
    assert within_bf16_rounding(df_g, want)
    assert within_bf16_rounding(df_c, want)
    assert (dw_g - dw_c).abs().max() <= 1e-5 * dw_c.abs().max()


def test_predict_on_card_matches_cpu(cuda):
    """The tiny narrow model on a ScanNet scene: K1, K3 and the NMS
    kernels launched once each; the outputs equal to the CPU's or within
    1e-4."""
    base = tiny_test_config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, neck3d_out_channels=16,
        backbone=dataclasses.replace(base.model.backbone,
                                     fpn_out_channels=32)))
    scene = make_synthetic_scene(cfg, seed=0, n_views=5, n_targets=2)
    gen = lambda: torch.Generator().manual_seed(0)
    want = make_predict_fn(build_model(cfg, "cpu", gen()), "cpu")(scene)
    launches = (composite_tiles.launches, weighted_gather_sum.launches,
                nms.nms3d.launches)
    got = make_predict_fn(build_model(cfg, "cuda", gen()))(scene)
    assert (composite_tiles.launches, weighted_gather_sum.launches,
            nms.nms3d.launches) == (launches[0] + 1, launches[1] + 1,
                                    launches[2] + 1)
    np.testing.assert_allclose(got["rendered"], want["rendered"], atol=1e-4)
    np.testing.assert_allclose(got["depth_expect"], want["depth_expect"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    mask = want["mask"]
    np.testing.assert_array_equal(got["labels"][mask], want["labels"][mask])
    np.testing.assert_allclose(got["boxes"][mask], want["boxes"][mask],
                               rtol=1e-4, atol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    """Two steps of the tiny narrow model, on the card and on the CPU from
    the same weights: each of the five kernels and the lift's row index
    launched once per step, the losses within 1e-4 relative."""
    base = tiny_test_config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, neck3d_out_channels=16,
        backbone=dataclasses.replace(base.model.backbone,
                                     fpn_out_channels=32)),
        optim=dataclasses.replace(base.optim, lr=2e-5))
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    states = {dev: create_train_state(
        cfg, dev, torch.Generator().manual_seed(0), sweep_chunk=2)
        for dev in ("cpu", "cuda")}
    kernels = (composite_tiles, composite_tiles_bwd, weighted_gather_sum,
               weighted_gather_sum_dfeat, weighted_gather_sum_dweight,
               lift_rows)
    before = [k.launches for k in kernels]
    metrics = {dev: [make_train_step(st)(scene) for _ in range(2)]
               for dev, st in states.items()}
    assert [k.launches for k in kernels] == [b + 2 for b in before]
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        for key, value in want.items():
            assert abs(got[key].item() - value.item()) <= \
                1e-4 * abs(value.item()), key


NMS_EDGES = ["random", "all_scores_equal", "score_ties", "no_valid_row",
             "fewer_valid_than_max_out", "duplicate_boxes",
             "zero_size_boxes", "m_1", "m_63", "m_64", "m_65"]
# float32 and bfloat16 (the boxes and scores a bf16 model may hand the
# NMS) on every edge; float16 and float64 on a few
NMS_CASES = ([(edge, "float32") for edge in NMS_EDGES]
             + [(edge, "bfloat16") for edge in NMS_EDGES]
             + [(edge, dtype) for dtype in ("float16", "float64")
                for edge in ("random", "score_ties", "zero_size_boxes",
                             "m_65")])


def nms_case(edge: str, rotated: bool, seed: int):
    """The ARKit predict's NMS at its full candidate count (3 levels of
    nms_pre: 1000 + 1000 + 400 = 2,400 boxes, 17 classes, 256 picks), or
    one named edge of it; yaw boxes (M, 7) or corner boxes (M, 6)."""
    rng = np.random.RandomState(seed)
    m = int(edge[2:]) if edge.startswith("m_") else 2400
    centre = np.concatenate([rng.uniform(-2, 2, (m, 2)),
                             rng.uniform(0, 1.5, (m, 1))], 1)
    size = rng.uniform(0.2, 2.0, (m, 3))
    yaw = rng.uniform(-np.pi, np.pi, (m, 1))
    if edge == "duplicate_boxes":
        centre[1::2], size[1::2], yaw[1::2] = centre[::2], size[::2], yaw[::2]
    if edge == "zero_size_boxes":     # points, and boxes flat in z
        size[::3] = 0.0
        size[1::7, 2] = 0.0
    boxes = (np.concatenate([centre, size, yaw], 1) if rotated
             else np.concatenate([centre - size / 2, centre + size / 2], 1))
    scores = rng.rand(m).astype(np.float32)
    if edge == "all_scores_equal":
        scores[:] = 0.5
    elif edge in ("score_ties", "duplicate_boxes"):
        scores = np.round(scores * 8).astype(np.float32) / 8
    classes = rng.randint(0, 17, m)
    valid = scores > 0.1
    if edge == "duplicate_boxes":
        classes[1::2], scores[1::2] = classes[::2], scores[::2]
    if edge in ("all_scores_equal", "duplicate_boxes"):
        valid[:] = True
    elif edge == "no_valid_row":
        valid[:] = False
    elif edge == "fewer_valid_than_max_out":
        valid &= rng.rand(m) < 0.05
    return [torch.from_numpy(a) for a in (boxes.astype(np.float32), scores,
                                          classes, valid)]


def iou_gap(got: torch.Tensor, want: torch.Tensor):
    """The largest |got - want| (NaN where both are NaN counts as equal,
    NaN on one side only as inf) and the share of pairs that differ."""
    got, want = got.double(), want.double()
    both_nan = got.isnan() & want.isnan()
    diff = torch.where(both_nan, 0.0, (got - want).abs())
    diff = torch.where(diff.isnan(), torch.inf, diff)
    return diff.max().item(), (diff > 0).double().mean().item()


@pytest.mark.parametrize("rotated", [False, True], ids=["aligned",
                                                         "rotated"])
@pytest.mark.parametrize("edge,dtype", NMS_CASES,
                         ids=[f"{e}-{d}" if d != "float32" else e
                              for e, d in NMS_CASES])
def test_rotated_nms_on_card_matches_cpu(cuda, edge, dtype, rotated):
    """The NMS kernels against the plain version, the boxes and scores in
    ``dtype``, one call of the kernel path.  float32: the kernel's IoU
    within 1e-5 of the plain IoU on the card (cos and sin of the CPU
    differ in the last bit, so the CPU's IoU is held to the same), the
    kept indices and mask equal to the CPU's.  Other dtypes: against the
    plain version on the card, whose elementwise ops round each result to
    the dtype as the kernel does: the IoU within 1e-5 (float64), or
    within one epsilon of the dtype in at most 1e-4 of the pairs (bf16,
    float16: only the shoelace sum's order differs, in float before its
    one rounding), and the picks equal."""
    fn, ref, iou = (
        (nms.rotated_3d_nms, nms.rotated_3d_nms_reference,
         nms.rotated_iou_bev_exact) if rotated
        else (nms.aligned_3d_nms, nms.aligned_3d_nms_reference,
              nms.aligned_iou_3d))
    dt = getattr(torch, dtype)
    cpu = nms_case(edge, rotated, NMS_EDGES.index(edge))
    cpu[0], cpu[1] = cpu[0].to(dt), cpu[1].to(dt)
    card = [t.to(cuda) for t in cpu]
    iou_kernel = nms.nms3d_iou(card[0], rotated)
    assert iou_kernel.dtype == dt
    gap, share = iou_gap(iou_kernel, iou(card[0], card[0]))
    if dt in (torch.float32, torch.float64):
        assert gap <= 1e-5
    else:
        assert gap <= torch.finfo(dt).eps and share <= 1e-4, (gap, share)
    if dt == torch.float32:
        iou_cpu = iou(cpu[0], cpu[0])
        assert iou_gap(iou_kernel.cpu(), iou_cpu)[0] <= 1e-5
        # the CPU's picks (`fn` on CPU tensors), its IoU computed once
        want = nms._greedy_nms(iou_cpu, cpu[1], cpu[2], 0.25, cpu[3], 256)
    else:
        want = [t.cpu() for t in ref(card[0], card[1], card[2], 0.25,
                                     card[3], 256)]
    launches = nms.nms3d.launches
    got = fn(card[0], card[1], card[2], 0.25, card[3], 256)
    assert nms.nms3d.launches == launches + 1
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    if edge == "random":
        assert want[1].sum() > 100
    if edge == "duplicate_boxes":       # never both boxes of a pair
        kept = want[0][want[1]] // 2
        assert kept.unique().numel() == kept.numel()


def picks_row_by_row(boxes, scores, classes, thr, valid, max_out):
    """`aligned_3d_nms_reference`'s picks with each pick's IoU row
    computed when it is picked: `_greedy_nms` reads no other row of its
    IoU matrix."""
    active = torch.where(valid, scores, -torch.inf)
    keep_idx = torch.zeros(max_out, dtype=torch.int64, device=boxes.device)
    keep_mask = torch.zeros(max_out, dtype=torch.bool, device=boxes.device)
    for t in range(max_out):
        i = int(torch.argmax(active))
        if not bool(active[i] > -torch.inf):
            break
        keep_idx[t], keep_mask[t] = i, True
        row = (nms.aligned_iou_3d(boxes[i:i + 1], boxes)[0] > thr) \
            & (classes == classes[i])
        row[i] = True
        active = torch.where(row, -torch.inf, active)
    return keep_idx, keep_mask


@pytest.mark.parametrize("m,score_dtype", [(60_000, torch.float32),
                                           (30_000, torch.float64)],
                         ids=["float32_keys", "float64_keys"])
def test_nms_keys_beyond_shared_memory(cuda, m, score_dtype):
    """More candidates than the greedy block's shared memory holds keys
    for (~58,000 32-bit keys or ~29,000 64-bit ones in an H100's 227 KB),
    so the keys live in global memory; the boxes spread over a room
    sqrt(M / 2,400) times as wide as `nms_case`'s, so that each overlaps
    as many: the picks equal the plain version's (`picks_row_by_row`: at
    this M the plain IoU matrix's broadcast intermediates would not fit
    the card)."""
    rng = np.random.RandomState(17)
    spread = 2.0 * np.sqrt(m / 2400)
    centre = np.concatenate([rng.uniform(-spread, spread, (m, 2)),
                             rng.uniform(0, 1.5, (m, 1))], 1)
    size = rng.uniform(0.2, 2.0, (m, 3))
    boxes = torch.from_numpy(np.concatenate(
        [centre - size / 2, centre + size / 2], 1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(m)).to(score_dtype)
    classes = torch.from_numpy(rng.randint(0, 17, m))
    boxes, scores, classes = (t.to(cuda) for t in (boxes, scores, classes))
    args = (boxes, scores, classes, 0.25, scores > 0.1, 256)
    launches = nms.nms3d.launches
    got = nms.aligned_3d_nms(*args)
    assert nms.nms3d.launches == launches + 1
    want = picks_row_by_row(*args)
    assert want[1].sum() == 256
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_arkit_predict_on_card_matches_cpu(cuda):
    """The tiny narrow model with the yaw head on an ARKit scene (per-view
    and per-target intrinsics): K1, K3 and the NMS kernels launched once
    each; outputs as `test_predict_on_card_matches_cpu` holds them, boxes
    (max_det, 7)."""
    base = tiny_test_config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, neck3d_out_channels=16,
        backbone=dataclasses.replace(base.model.backbone,
                                     fpn_out_channels=32),
        head=dataclasses.replace(base.model.head, n_reg_outs=7,
                                 with_yaw=True)))
    scene = make_synthetic_scene(cfg, seed=0, n_views=5, n_targets=2,
                                 arkit=True)
    gen = lambda: torch.Generator().manual_seed(0)
    want = make_predict_fn(build_model(cfg, "cpu", gen()), "cpu")(scene)
    launches = (composite_tiles.launches, weighted_gather_sum.launches,
                nms.nms3d.launches)
    got = make_predict_fn(build_model(cfg, "cuda", gen()))(scene)
    assert (composite_tiles.launches, weighted_gather_sum.launches,
            nms.nms3d.launches) == (launches[0] + 1, launches[1] + 1,
                                    launches[2] + 1)
    assert got["boxes"].shape == (cfg.model.head.max_detections, 7)
    np.testing.assert_allclose(got["rendered"], want["rendered"], atol=1e-4)
    np.testing.assert_allclose(got["depth_expect"], want["depth_expect"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    mask = want["mask"]
    np.testing.assert_array_equal(got["labels"][mask], want["labels"][mask])
    np.testing.assert_allclose(got["boxes"][mask], want["boxes"][mask],
                               rtol=1e-4, atol=1e-4)
