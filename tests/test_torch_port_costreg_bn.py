"""Training CostRegNet in BatchNorm mode (`cost_reg_norm="batch"`) in the
port, against JAX `train_step`.

`narrow(tiny_test_config())` with `cost_reg_norm="batch"`, a synthetic
scene of 4 views and 2 targets, one numpy-seeded variable tree carried
across by the weight bridge (its CostRegNet `batch_stats` included).  One
training step on each side, sweep chunk 2: JAX collapses the sweep to one
chunk of all views when BatchNorm trains (mvsdet_tpu/models/mvsdet.py:
128-139), so the port must too.  Losses to 1e-5, step-1 gradients to 1e-4
relative, and every running mean and variance of CostRegNet and the neck
after the step to 1e-5; and the statistics move once a step, not again
when backward recomputes a checkpointed chunk (ROADMAP T21).
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.training.loop import TrainState as JxTrainState
from mvsdet_tpu.training.loop import train_step as jx_train_step
from mvsdet_tpu.training.optim import build_optimizer as jx_build_optimizer

from mvsdet_torch import config as port_config
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.training.loop import create_train_state, train_step

from test_torch_port_arkit import arkit, grad_recorder, rel, tensors
from test_torch_port_interop import random_variables
from test_torch_port_training import train_config


def batch_norm(cfg):
    """A config of either package with CostRegNet in BatchNorm mode."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, cost_reg_norm="batch"))


@pytest.fixture(scope="module")
def step():
    """One JAX `train_step` (its gradients recorded) and one port
    `train_step` from one tree; the port's step-1 gradients from a copy
    of its model, since `train_step` clips in place."""
    cfg = batch_norm(train_config(tiny_test_config()))
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)
    tree = random_variables(jx_model, batch, method=JxMVSDet.loss)
    tx = optax.chain(grad_recorder(),
                     jx_build_optimizer(cfg.optim, tree["params"],
                                        steps_per_epoch=1))
    state = JxTrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                         batch_stats=tree["batch_stats"],
                         frozen=tree["frozen"],
                         opt_state=tx.init(tree["params"]))
    new_state, metrics = jax.jit(lambda s, b: jx_train_step(
        jx_model, tx, s, b))(state, batch)
    pcfg = batch_norm(train_config(port_config.tiny_test_config()))
    pt = create_train_state(pcfg, device="cpu", sweep_chunk=2,
                            steps_per_epoch=1, sweep_method="gather")
    load_flax_variables(pt.model, tree)
    initial = copy.deepcopy(pt.model)
    probe = copy.deepcopy(pt.model)
    probe.loss(tensors(scene))[0].backward()
    pt_metrics = train_step(pt, tensors(scene))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(
        scene=scene, initial=initial,
        jx_metrics={k: float(v) for k, v in metrics.items()},
        jx_grads=flax_to_state_dict({"params": host(new_state.opt_state[0])}),
        jx_stats=flax_to_state_dict({"batch_stats": host(
            new_state.batch_stats)}),
        pt_metrics={k: float(v) for k, v in pt_metrics.items()},
        pt_grads={k: p.grad for k, p in probe.named_parameters()},
        pt_state=pt.model.state_dict())


def test_batch_norm_step_losses_match_jax(step):
    want, got = step["jx_metrics"], step["pt_metrics"]
    assert set(got) == set(want)
    assert got["n_pos"] == want["n_pos"] > 0
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-5 * abs(value), key


def test_batch_norm_step_gradients_match_jax(step):
    """Every trained leaf's step-1 gradient to 1e-4 relative, CostRegNet's
    BatchNorm scales and biases among them."""
    jx_grads, pt_grads = step["jx_grads"], step["pt_grads"]
    assert set(pt_grads) == set(jx_grads)
    assert "cost_reg.conv0.norm.weight" in jx_grads
    for name, want in jx_grads.items():
        got = pt_grads[name]
        if got is None:      # frozen (stem, layer1) or unused (FPN out1-3)
            assert not np.any(want), name
            continue
        assert rel(got.numpy(), want) <= 1e-4, name


def test_batch_norm_step_running_statistics_match_jax(step):
    """Every running mean and variance, CostRegNet's (computed over all
    four views at once) and the neck's, to 1e-5 after the step; each
    moved."""
    stats, initial = step["jx_stats"], step["initial"].state_dict()
    cost_reg = [k for k in stats if k.startswith("cost_reg.")]
    assert len(cost_reg) == 14 and any(k.startswith("neck3d.") for k in stats)
    for name, want in stats.items():
        got = step["pt_state"][name]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert not torch.equal(got, initial[name]), name


def test_batch_norm_statistics_move_once_per_step(step):
    """With `sweep_remat` (the default), a loss and its backward leave the
    running statistics where the loss alone left them: the one-chunk
    BatchNorm sweep runs without checkpoint, whose recompute in backward
    would move them a second time."""
    scene = tensors(step["scene"])
    forward_only, with_backward = (copy.deepcopy(step["initial"])
                                   for _ in range(2))
    assert forward_only.sweep_remat
    forward_only.loss(scene)
    with_backward.loss(scene)[0].backward()
    a, b = forward_only.state_dict(), with_backward.state_dict()
    names = [k for k in a if k.startswith("cost_reg.")
             and k.endswith(("running_mean", "running_var"))]
    assert len(names) == 14
    for name in names:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a[names[0]],
                           step["initial"].state_dict()[names[0]])


@pytest.mark.parametrize("preset", ["arkit", "batch_norm"])
def test_bridge_maps_the_arkit_and_batch_norm_trees(preset):
    """Every leaf of a JAX tree for the yaw head (7 box channels) or for
    CostRegNet in BatchNorm mode (its scales, biases and `batch_stats`)
    lands on one port key, with nothing left over on either side."""
    change = arkit if preset == "arkit" else batch_norm
    cfg = change(train_config(tiny_test_config()))
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_scene(
        cfg, seed=0, n_views=3, n_targets=1, arkit=preset == "arkit").items()}
    tree = random_variables(JxMVSDet(cfg.model, sweep_method="gather"),
                            batch, method=JxMVSDet.loss)
    model = MVSDet(change(train_config(port_config.tiny_test_config())).model,
                   sweep_method="gather")
    load_flax_variables(model, tree)
    arrays = flax_to_state_dict(tree)
    state = model.state_dict()
    keys = [k for k in state if not k.endswith("num_batches_tracked")]
    assert len(arrays) == len(jax.tree_util.tree_leaves(tree)) == len(keys)
    for key, value in arrays.items():
        np.testing.assert_array_equal(state[key].numpy(), value)
    if preset == "arkit":
        assert state["head.conv_reg.weight"].shape[0] == 7
    else:
        np.testing.assert_array_equal(
            state["cost_reg.conv0.norm.running_var"],
            tree["batch_stats"]["cost_reg"]["conv0"]["BatchNorm_0"]["var"])
