"""The port's whole predict path against JAX `MVSDet(sweep_method="gather")`.

Both run the same synthetic scene with the same weights (a numpy-seeded
JAX tree carried across by the bridge) at tiny shapes and narrow widths:
rendered to 1e-4, depth expectation to 1e-5, kept boxes, scores and
labels equal under `mask` (ROADMAP trap T9).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models.head import head_predict as jx_head_predict
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.ops import nms as jx_nms

from mvsdet_torch import config as port_config
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.interop import load_flax_variables
from mvsdet_torch.models.head import head_predict
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.ops import nms

from test_torch_port_interop import narrow, random_variables


@pytest.fixture(scope="module")
def runs():
    cfg = narrow(tiny_test_config())
    scene = make_synthetic_scene(cfg, seed=0, n_views=5, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather")
    tree = random_variables(jx_model, batch, method=JxMVSDet.predict)

    @jax.jit
    def jx_run(tree, batch):
        res = jx_model.apply(tree, batch)
        pred = jx_head_predict(res["head_outs"], res["points"],
                               res["valids"], cfg.model.head)
        return res, pred

    res_j, pred_j = jax.tree_util.tree_map(np.asarray, jx_run(tree, batch))

    model = MVSDet(narrow(port_config.tiny_test_config()).model)
    load_flax_variables(model, tree)
    model.eval()
    pred_t = make_predict_fn(model, device="cpu")(scene)
    with torch.no_grad():
        res_t = model({k: torch.from_numpy(v) for k, v in scene.items()})
    return cfg, res_j, pred_j, res_t, pred_t


def test_depth_matches_jax(runs):
    _, res_j, _, res_t, pred_t = runs
    for key in ("prob", "est_prob", "est_depth", "depth_expect"):
        np.testing.assert_allclose(res_t[key].numpy(), res_j[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(pred_t["depth_expect"], res_j["depth_expect"],
                               rtol=1e-5, atol=1e-5)


def test_lift_validity_and_levels_match_jax(runs):
    _, res_j, _, res_t, _ = runs
    np.testing.assert_array_equal(res_t["valid_count"].numpy(),
                                  res_j["valid_count"])
    assert res_j["valid_count"].max() > 0
    for got, want in zip(res_t["valids"], res_j["valids"]):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(res_t["levels"], res_j["levels"]):
        np.testing.assert_allclose(got[0].permute(1, 2, 3, 0).numpy(), want,
                                   rtol=1e-4, atol=1e-4)


def test_gaussians_match_jax(runs):
    _, res_j, _, res_t, _ = runs
    for field in ("means", "covariances", "harmonics", "opacities"):
        np.testing.assert_allclose(
            getattr(res_t["gaussians"], field).numpy(),
            getattr(res_j["gaussians"], field), rtol=1e-5, atol=1e-5,
            err_msg=field)
    # the two targets share source views: duplicate slots get opacity 0
    assert (res_j["gaussians"].opacities == 0).any()


def test_predict_matches_jax(runs):
    cfg, res_j, pred_j, _, pred_t = runs
    assert pred_t["rendered"].shape == (2,) + cfg.model.target_size + (3,)
    np.testing.assert_allclose(pred_t["rendered"], res_j["rendered"],
                               rtol=1e-4, atol=1e-4)
    mask = pred_j["mask"]
    np.testing.assert_array_equal(pred_t["mask"], mask)
    assert mask.sum() > 0
    np.testing.assert_array_equal(pred_t["labels"][mask],
                                  pred_j["labels"][mask])
    np.testing.assert_allclose(pred_t["scores"][mask], pred_j["scores"][mask],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred_t["boxes"][mask], pred_j["boxes"][mask],
                               rtol=1e-5, atol=1e-5)


def test_head_predict_on_equal_inputs(runs):
    cfg, res_j, pred_j, _, _ = runs
    pred = head_predict(
        [tuple(torch.tensor(t) for t in lvl) for lvl in res_j["head_outs"]],
        [torch.tensor(p) for p in res_j["points"]],
        [torch.tensor(v) for v in res_j["valids"]],
        port_config.tiny_test_config().model.head)
    mask = pred_j["mask"]
    np.testing.assert_array_equal(pred["mask"].numpy(), mask)
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(pred[key].numpy()[mask],
                                      pred_j[key][mask], err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_matches_jax(seed):
    rng = np.random.RandomState(seed)
    m = 60
    lo = rng.uniform(-0.5, 0.5, (m, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 0.8, (m, 3))], 1) \
        .astype(np.float32)
    scores = rng.rand(m).astype(np.float32)
    classes = rng.randint(0, 3, m).astype(np.int32)
    valid = rng.rand(m) > 0.2
    np.testing.assert_allclose(
        nms.aligned_iou_3d(torch.from_numpy(boxes), torch.from_numpy(boxes))
        .numpy(), np.asarray(jx_nms.aligned_iou_3d(boxes, boxes)), rtol=1e-6,
        atol=1e-7)
    idx_j, mask_j = jx_nms.aligned_3d_nms(boxes, scores, classes, 0.25, valid,
                                          m)
    idx_t, mask_t = nms.aligned_3d_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), 0.25, torch.from_numpy(valid), m)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert 0 < mask_t.sum() < valid.sum()      # some boxes suppressed
