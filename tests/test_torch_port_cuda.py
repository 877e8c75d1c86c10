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
from mvsdet_torch.ops.lift_kernel import (
    weighted_gather_sum, weighted_gather_sum_dfeat,
    weighted_gather_sum_dfeat_reference, weighted_gather_sum_dweight,
    weighted_gather_sum_dweight_reference, weighted_gather_sum_reference)
from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                           composite_tiles_bwd,
                                           composite_tiles_bwd_reference,
                                           composite_tiles_reference)
from mvsdet_torch.training.loop import create_train_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tables(n_tiles, k, c, tiles_x, seed=0):
    """Tile tables in the compositor's layout, 30% of slots empty."""
    rng = np.random.RandomState(seed)
    data = np.zeros((n_tiles, 8, k), np.float32)
    data[:, 0] = rng.uniform(-8, tiles_x * 16 + 8, (n_tiles, k))
    data[:, 1] = rng.uniform(-8, n_tiles // tiles_x * 16 + 8, (n_tiles, k))
    data[:, 2] = rng.uniform(0.02, 0.5, (n_tiles, k))
    data[:, 3] = rng.uniform(-0.02, 0.02, (n_tiles, k))
    data[:, 4] = rng.uniform(0.02, 0.5, (n_tiles, k))
    data[:, 5] = rng.uniform(0, 0.95, (n_tiles, k)) * (rng.rand(n_tiles, k)
                                                        >= 0.3)
    vals = rng.rand(n_tiles, c, k).astype(np.float32)
    return torch.from_numpy(data), torch.from_numpy(vals)


@pytest.mark.parametrize("n_tiles,k,c,tiles_x", [
    (24, 512, 3, 4),            # two stacked 4x3-tile views
    (10, 300, 1, 5),            # K not a multiple of the staged chunk
    (6, 2048, 4, 3),            # the predict capacity, four channels
])
def test_compositor_matches_plain_version(cuda, n_tiles, k, c, tiles_x):
    data, vals = (t.to(cuda) for t in tables(n_tiles, k, c, tiles_x))
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


@pytest.mark.parametrize("n_tiles,k,c,tiles_x", [
    (24, 512, 3, 4),            # two stacked 4x3-tile views
    (10, 300, 1, 5),            # K not a multiple of the staged chunk
    (6, 2048, 4, 3),            # the training capacity, four channels
])
def test_compositor_backward_matches_plain_version(cuda, n_tiles, k, c,
                                                   tiles_x):
    data, vals = tables(n_tiles, k, c, tiles_x, seed=k)
    data[:, 5, :k // 10] = 1.3                          # clipped at 0.99
    g = torch.from_numpy(np.random.RandomState(c).randn(
        n_tiles, c + 1, 256).astype(np.float32))       # g_T != 0
    data, vals, g = (t.to(cuda) for t in (data, vals, g))
    launches = composite_tiles_bwd.launches
    got = composite_tiles_bwd(data, vals, g, tiles_x)
    torch.cuda.synchronize()
    assert composite_tiles_bwd.launches == launches + 1
    for a, b in zip(got, composite_tiles_bwd_reference(data, vals, g,
                                                       tiles_x)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    assert torch.all(got[0][:, 6:] == 0)


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
    before = (weighted_gather_sum.launches,
              weighted_gather_sum_dfeat.launches,
              weighted_gather_sum_dweight.launches)
    weighted_gather_sum(feat, pix, w).sum().backward()
    assert (weighted_gather_sum.launches,
            weighted_gather_sum_dfeat.launches,
            weighted_gather_sum_dweight.launches) == tuple(
                b + 1 for b in before)
    assert feat.grad is not None and w.grad is not None


def test_gather_refuses_a_misaligned_feature_map(cuda):
    feat = torch.zeros(2 * 6 * 4 + 1, device=cuda)[1:].reshape(2, 6, 4)
    with pytest.raises(ValueError, match="16-byte"):
        weighted_gather_sum(feat, torch.zeros(2, 5, dtype=torch.int32,
                                              device=cuda),
                            torch.zeros(2, 5, device=cuda))


def test_predict_on_card_matches_cpu(cuda):
    base = tiny_test_config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, neck3d_out_channels=16,
        backbone=dataclasses.replace(base.model.backbone,
                                     fpn_out_channels=32)))
    scene = make_synthetic_scene(cfg, seed=0, n_views=5, n_targets=2)
    gen = lambda: torch.Generator().manual_seed(0)
    want = make_predict_fn(build_model(cfg, "cpu", gen()), "cpu")(scene)
    launches = (composite_tiles.launches, weighted_gather_sum.launches)
    got = make_predict_fn(build_model(cfg, "cuda", gen()))(scene)
    assert (composite_tiles.launches, weighted_gather_sum.launches) == \
        (launches[0] + 1, launches[1] + 1)
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
    the same weights: each of the five kernels launched once per step, the
    losses within 1e-4 relative."""
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
               weighted_gather_sum_dfeat, weighted_gather_sum_dweight)
    before = [k.launches for k in kernels]
    metrics = {dev: [make_train_step(st)(scene) for _ in range(2)]
               for dev, st in states.items()}
    assert [k.launches for k in kernels] == [b + 2 for b in before]
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        for key, value in want.items():
            assert abs(got[key].item() - value.item()) <= \
                1e-4 * abs(value.item()), key
