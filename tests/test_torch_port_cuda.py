"""The port's CUDA kernels and its predict path on the card.

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
from mvsdet_torch.ops.lift_kernel import (weighted_gather_sum,
                                          weighted_gather_sum_reference)
from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                           composite_tiles_reference)

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


def test_kernels_refuse_inputs_that_require_grad(cuda):
    d = torch.zeros(2, 8, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        composite_tiles(d, torch.zeros(2, 3, 16, device=cuda), 2)
    w = torch.zeros(2, 5, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        weighted_gather_sum(torch.zeros(2, 6, 4, device=cuda),
                            torch.zeros(2, 5, dtype=torch.int32, device=cuda),
                            w)


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
