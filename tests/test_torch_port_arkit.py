"""The ARKit configuration through the port's predict and training step,
against the JAX package's.

`narrow(tiny_test_config())` with the yaw head (`with_yaw=True`,
`n_reg_outs=7`) on a synthetic ARKit scene of 4 views and 2 targets:
per-view and per-target intrinsics and 7-column boxes with a yaw.  Both
packages run the scene with one numpy-seeded variable tree carried across
by the weight bridge, both sweeping with the bilinear gather
(`sweep_method="gather"`; the default sweep in
`tests/test_torch_port_sweep_mxu.py`):

- predict: rendered to 1e-4, the lifted volume to 1e-5 relative, kept
  boxes, scores and labels under `mask` (the boxes also from JAX's own
  head outputs, within a few ulps);
- one training step against JAX `train_step`: losses to 1e-5, step-1
  gradients to 1e-4 relative, at the three-step test's lr (ROADMAP T14),
  and the neck's running statistics after the step to 1e-5;
- the loss terms in bf16 against JAX bf16 downstream of JAX bf16's own
  features, depth probabilities and neck levels, beside their
  bf16-vs-float32 witness.
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models.head import head_predict_rotated as jx_predict_rotated
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.training.loop import TrainState as JxTrainState
from mvsdet_tpu.training.loop import train_step as jx_train_step
from mvsdet_tpu.training.optim import build_optimizer as jx_build_optimizer

from mvsdet_torch import config as port_config
from mvsdet_torch.data.synthetic import \
    make_synthetic_scene as port_synthetic_scene
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models.head import head_predict_rotated
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.training.loop import create_train_state, train_step

from test_torch_port_interop import random_variables
from test_torch_port_training import train_config

BF16 = torch.bfloat16
EXACT_BF16 = {"xla_allow_excess_precision": False}
# the bf16 loss terms downstream of JAX bf16's own features, depth
# probabilities and neck levels (0.0 measured, 1.4e-7 for loss_nvs), as
# tests/test_torch_port_bf16.py holds ScanNet's; the witness (the whole
# loss, 1.1e-2) is asserted at least 4 times it
FORCED_TOL = 1e-4


def arkit(cfg):
    """A config of either package with the ARKit yaw head."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, n_reg_outs=7,
                                            with_yaw=True)))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def grad_recorder():
    """An optax stage that passes the updates on unchanged and keeps them
    in its state: chained before the optimizer, it hands out the step's
    raw gradients from the state `train_step` returns."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def setup():
    cfg = arkit(train_config(tiny_test_config()))
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2,
                                 arkit=True)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)
    tree = random_variables(jx_model, batch, method=JxMVSDet.loss)
    pcfg = arkit(train_config(port_config.tiny_test_config()))
    return dict(cfg=cfg, pcfg=pcfg, scene=scene, batch=batch,
                jx_model=jx_model, tree=tree)


def tensors(scene):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in scene.items()}


def test_scene_has_per_view_intrinsics_and_yaw_boxes(setup):
    """The port's scene generator gives the JAX package's ARKit scene."""
    scene = setup["scene"]
    assert scene["intrinsic"].shape == (4, 4, 4)
    assert scene["tgt_intrinsic"].shape == (2, 4, 4)
    assert scene["gt_boxes"].shape[-1] == 7
    assert not np.allclose(scene["intrinsic"][0], scene["intrinsic"][1])
    ours = port_synthetic_scene(setup["pcfg"], seed=0, n_views=4, n_targets=2,
                                arkit=True)
    assert set(ours) == set(scene)
    for key, value in scene.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


# -- predict ------------------------------------------------------------------

@pytest.fixture(scope="module")
def predicts(setup):
    """JAX's raw outputs, rotated prediction and lifted volume (the neck's
    input); the port's, through `make_predict_fn` on the CPU."""
    cfg, jx_model = setup["cfg"], setup["jx_model"]

    @jax.jit
    def jx_run(tree, batch):
        volume = {}

        def grab(next_fun, args, kwargs, context):
            if context.module.name == "neck3d":
                volume["in"] = args[0]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(grab):
            res = jx_model.apply(tree, batch)
        pred = jx_predict_rotated(res["head_outs"], res["points"],
                                  res["valids"], cfg.model.head)
        return res, pred, volume["in"]

    res_j, pred_j, vol_j = jax.tree_util.tree_map(
        np.asarray, jx_run(setup["tree"], setup["batch"]))
    model = MVSDet(setup["pcfg"].model, sweep_method="gather")
    load_flax_variables(model, setup["tree"])
    model.eval()
    volume = []
    model.neck3d.register_forward_pre_hook(
        lambda mod, args: volume.append(args[0]))
    pred_t = make_predict_fn(model, device="cpu")(setup["scene"])
    return dict(res_j=res_j, pred_j=pred_j, vol_j=vol_j, pred_t=pred_t,
                vol_t=volume[0].permute(0, 2, 3, 4, 1).numpy())


def test_arkit_predict_matches_jax(setup, predicts):
    """Rendered to 1e-4, lifted volume to 1e-5 relative, (max_det, 7)
    boxes, scores and labels equal under the mask."""
    cfg = setup["cfg"]
    res_j, pred_j, pred_t = (predicts["res_j"], predicts["pred_j"],
                             predicts["pred_t"])
    md = cfg.model.head.max_detections
    assert pred_t["boxes"].shape == pred_j["boxes"].shape == (md, 7)
    assert pred_t["rendered"].shape == (2,) + cfg.model.target_size + (3,)
    np.testing.assert_allclose(pred_t["rendered"], res_j["rendered"],
                               rtol=1e-4, atol=1e-4)
    assert rel(predicts["vol_t"], predicts["vol_j"]) <= 1e-5
    np.testing.assert_allclose(pred_t["depth_expect"], res_j["depth_expect"],
                               rtol=1e-5, atol=1e-5)
    mask = pred_j["mask"]
    assert mask.sum() > 0
    np.testing.assert_array_equal(pred_t["mask"], mask)
    np.testing.assert_array_equal(pred_t["labels"][mask],
                                  pred_j["labels"][mask])
    np.testing.assert_allclose(pred_t["scores"][mask], pred_j["scores"][mask],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred_t["boxes"][mask], pred_j["boxes"][mask],
                               rtol=1e-5, atol=1e-5)


def test_head_predict_rotated_on_equal_inputs(setup, predicts):
    """JAX's own head outputs through the port's rotated prediction: mask
    and labels equal; boxes and scores, which pass through cos, sin and
    exp (ROADMAP T19), within a few ulps."""
    res_j, pred_j = predicts["res_j"], predicts["pred_j"]
    pred = head_predict_rotated(
        [tuple(torch.tensor(t) for t in lvl) for lvl in res_j["head_outs"]],
        [torch.tensor(p) for p in res_j["points"]],
        [torch.tensor(v) for v in res_j["valids"]], setup["pcfg"].model.head)
    mask = pred_j["mask"]
    np.testing.assert_array_equal(pred["mask"].numpy(), mask)
    np.testing.assert_array_equal(pred["labels"].numpy()[mask],
                                  pred_j["labels"][mask])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(pred[key].numpy()[mask], pred_j[key][mask],
                                   rtol=5e-7, atol=5e-7, err_msg=key)


# -- one training step --------------------------------------------------------

@pytest.fixture(scope="module")
def step(setup):
    """One JAX `train_step` (with the step's gradients recorded) and one
    port `train_step` from the same tree; the port's step-1 gradients from
    a copy of its model, since `train_step` clips in place."""
    cfg, tree = setup["cfg"], setup["tree"]
    tx = optax.chain(grad_recorder(),
                     jx_build_optimizer(cfg.optim, tree["params"],
                                        steps_per_epoch=1))
    state = JxTrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                         batch_stats=tree["batch_stats"],
                         frozen=tree["frozen"],
                         opt_state=tx.init(tree["params"]))
    new_state, metrics = jax.jit(lambda s, b: jx_train_step(
        setup["jx_model"], tx, s, b))(state, setup["batch"])
    pt = create_train_state(setup["pcfg"], device="cpu", sweep_chunk=2,
                            steps_per_epoch=1, sweep_method="gather")
    load_flax_variables(pt.model, tree)
    probe = copy.deepcopy(pt.model)
    probe.loss(tensors(setup["scene"]))[0].backward()
    pt_metrics = train_step(pt, tensors(setup["scene"]))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(
        jx_metrics={k: float(v) for k, v in metrics.items()},
        jx_grads=flax_to_state_dict({"params": host(new_state.opt_state[0])}),
        jx_stats=flax_to_state_dict({"batch_stats": host(
            new_state.batch_stats)}),
        pt_metrics={k: float(v) for k, v in pt_metrics.items()},
        pt_grads={k: p.grad for k, p in probe.named_parameters()},
        pt_state=pt.model.state_dict())


def test_arkit_step_losses_match_jax(step):
    want, got = step["jx_metrics"], step["pt_metrics"]
    assert set(got) == set(want) == {"loss", "center_loss", "bbox_loss",
                                     "cls_loss", "loss_nvs", "n_pos"}
    assert got["n_pos"] == want["n_pos"] > 0
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-5 * abs(value), key


def test_arkit_step_gradients_match_jax(step):
    """Every trained leaf's step-1 gradient to 1e-4 relative, the 7-channel
    box regression's included."""
    jx_grads, pt_grads = step["jx_grads"], step["pt_grads"]
    assert set(pt_grads) == set(jx_grads)
    assert pt_grads["head.conv_reg.weight"].shape[0] == 7
    for name, want in jx_grads.items():
        got = pt_grads[name]
        if got is None:      # frozen (stem, layer1) or unused (FPN out1-3)
            assert not np.any(want), name
            continue
        assert rel(got.numpy(), want) <= 1e-4, name


def test_arkit_step_moves_the_neck_statistics_as_jax(step):
    stats = step["jx_stats"]
    assert stats and all(k.startswith("neck3d.") for k in stats)
    for name, want in stats.items():
        np.testing.assert_allclose(step["pt_state"][name].numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# -- bf16 ---------------------------------------------------------------------

def test_arkit_losses_downstream_match_jax_bf16(setup, step):
    """The ARKit loss with the networks in bf16, JAX bf16's own FPN
    features, depth probabilities and neck levels handed to the port (as
    tests/test_torch_port_bf16.py holds ScanNet's): the lift with per-view
    Ks (its volume into the neck within FORCED_TOL), the yaw head, the
    rotated loss, the per-view Gaussians and the per-target render, every
    loss term within FORCED_TOL of JAX bf16, whose distance from JAX
    float32 is the witness.  The decoded boxes and the rotated loss run in
    float32, as in JAX.  The backbone, CostRegNet and the train-mode neck
    are held block by block in bf16 by that file: their ulp flips spread,
    so that free-running this tree's loss lands 8.7e-3 from JAX bf16's
    (witness 1.1e-2) and, with the neck free, the centerness term 5.3e-4."""
    jx16 = JxMVSDet(setup["cfg"].model, sweep_method="gather", sweep_chunk=2,
                    dtype=jnp.bfloat16)

    def run(t, b):
        neck = {}

        def grab(next_fun, args, kwargs, context):
            if context.module.name == "neck3d":
                neck["in"] = args[0]
                neck["out"] = next_fun(*args, **kwargs)
                return neck["out"]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(grab):
            (total, aux), inter = jx16.apply(
                t, b, method=JxMVSDet.loss,
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, method: method in (
                    "image_features", "depth_probabilities"))
        inter = inter["intermediates"]
        return (total, aux, inter["image_features"][0],
                inter["depth_probabilities"][0], neck["in"], neck["out"])

    total, aux, feats, (prob, off), want_volume, levels = jax.jit(
        run, compiler_options=EXACT_BF16)(setup["tree"], setup["batch"])
    want = {k: float(v) for k, v in aux.items()} | {"loss": float(total)}

    def bf16(x):
        return torch.from_numpy(np.array(jnp.asarray(x).astype(
            jnp.float32))).to(BF16)

    model = MVSDet(setup["pcfg"].model, sweep_chunk=2, dtype=BF16,
                   sweep_method="gather")
    load_flax_variables(model, setup["tree"])
    model.train()
    volume = []
    model.image_features = lambda images: bf16(feats)
    model.depth_probabilities = lambda *args: (
        torch.from_numpy(np.array(prob)), torch.from_numpy(np.array(off)))
    model.neck3d.forward = lambda x, train=False: (
        volume.append(x) or [bf16(l).permute(0, 4, 1, 2, 3) for l in levels])
    total, got = model.loss(tensors(setup["scene"]))
    got = {k: v.item() for k, v in got.items()} | {"loss": total.item()}
    assert total.dtype == torch.float32
    assert volume[0].dtype == BF16
    assert rel(volume[0].float().permute(0, 2, 3, 4, 1).numpy(),
               np.asarray(want_volume.astype(jnp.float32))) <= FORCED_TOL
    assert got["n_pos"] == want["n_pos"] > 0
    want32 = step["jx_metrics"]
    for key in ("loss", "center_loss", "bbox_loss", "cls_loss", "loss_nvs"):
        err = abs(got[key] - want[key]) / abs(want[key])
        assert err <= FORCED_TOL, (key, err)
    witness = abs(want32["loss"] - want["loss"]) / want["loss"]
    assert witness >= 4 * FORCED_TOL, witness
