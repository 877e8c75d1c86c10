"""The port's data x view parallelism against the JAX package's `shard_map`
step, on the CPU.

The port's ranks are processes spawned over gloo (`_parallel_ranks.py`,
a file store under each test's directory); JAX runs in the pytest
process on conftest's 8 virtual CPU devices, meanwhile.  Both start from
one numpy-seeded variable tree carried across by the weight bridge, at
`narrow(tiny_test_config())` with lr 2e-5 (ROADMAP T14):

- (a) `make_mesh`'s layout and its refusal of a wrong world size;
- (b) `all_gather_views` and `psum`: a small function's value and
  gradients at 2 ranks against `shard_map` on `make_mesh(1, 2)` with
  ``check_vma=False``;
- (c)-(f) one sharded step through `fit` at data 2 x view 1, data 1 x
  view 2, ARKit at data 2, CostRegNet in BatchNorm mode at view 2, and
  data 2 x view 2 at 4 ranks, against JAX `make_sharded_train_step` on
  the same mesh (its gradients recorded by an optax stage chained before
  the optimizer): the loss terms to 1e-4 relative, `n_pos` equal, the
  averaged gradients to 1e-4 relative per leaf, every parameter and
  running statistic after the step within 1e-6 of JAX's but for at most
  NOISE_ELEMENTS elements, each within 3 lr (Adam's first step turns a
  gradient of rounding noise into +-lr; the training tests count them
  so too), every rank's parameters bit-equal, and rank 0 alone writing
  `fit`'s checkpoint; (d) also holds the
  view-sharded gradients against the port's unsharded ones (1e-4
  relative per leaf).  BatchNorm over each rank's two views is noisy in
  JAX itself: its sharded step's gradients are up to 1.1e-2 from those of
  JAX's unsharded step with the same two-view BatchNorm chunks
  (`SplitBatchNormSweep`), so that case's gradients and noise count are
  held to twice that witness, computed in the test;
- (g) `evaluate_scenes` with `group_size=2` at 2 ranks on 3 scenes:
  predictions equal to `make_predict_fn`'s per scene, metrics equal to
  `group_size=1`'s, and to JAX's sharded `evaluate_scenes` (APs to 1e-6,
  psnr and ssim to 1e-4 relative), with a head that detects;
- (h) `depth_supervision` with the views sharded: the port refuses it
  (JAX fails to trace it at 2 view ranks of 4 views; run this file as a
  script for what JAX computes at 4 ranks of 4 views).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.evaluation import harness as jx_harness
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.parallel.mesh import make_mesh as jx_make_mesh
from mvsdet_tpu.parallel.sharding import \
    make_sharded_train_step as jx_sharded_step
from mvsdet_tpu.parallel.sharding import shard_batch as jx_shard_batch
from mvsdet_tpu.training.loop import TrainState as JxTrainState
from mvsdet_tpu.training.loop import train_step as jx_train_step
from mvsdet_tpu.training.optim import build_optimizer as jx_build_optimizer

from mvsdet_torch import config as port_config
from mvsdet_torch.evaluation.harness import evaluate_scenes, make_predict_fn
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models.mvsdet import DEPTH_SUPERVISION_SHARDED, MVSDet
from mvsdet_torch.parallel import mesh as port_mesh
from mvsdet_torch.parallel.sharding import make_sharded_train_step
from mvsdet_torch.tools import train as train_launcher
from mvsdet_torch.training.loop import create_train_state

import _parallel_ranks as ranks
from test_torch_port_arkit import arkit, grad_recorder
from test_torch_port_interop import narrow, random_variables
from test_torch_port_launchers import detecting_head
from test_torch_port_training import LR, NOISE_ELEMENTS, rel, train_config

# past rounding: an element of a parameter or statistic after one step
# further than this from JAX's is counted as noise (see the docstring)
STEP_TOL = 1e-6


def batch_norm(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, cost_reg_norm="batch"))


CASES = {
    # name: (data, view, config change, arkit scenes)
    "data2": (2, 1, lambda c: c, False),
    "view2": (1, 2, lambda c: c, False),
    "arkit_data2": (2, 1, arkit, True),
    "batch_norm_view2": (1, 2, batch_norm, False),
    "data2_view2": (2, 2, lambda c: c, False),
}


def save_scenes(path, scenes):
    np.savez(path, **{f"{i}/{k}": v for i, s in enumerate(scenes)
                      for k, v in s.items()})
    return str(path)


def save_weights(path, cfg, tree):
    """The JAX tree as the port model's state dict, in a file the ranks
    load."""
    model = MVSDet(cfg.model)
    load_flax_variables(model, tree)
    torch.save(model.state_dict(), path)
    return str(path)


class SplitBatchNormSweep(JxMVSDet):
    """The JAX module whose sweep runs CostRegNet on the first and the
    second half of the views apart, as two view ranks run it, without
    sharding: in BatchNorm mode each half is normalised on its own."""

    def depth_probabilities(self, features, proj44, neighbor_ids, train,
                            ref_ids=None):
        if ref_ids is not None:
            return super().depth_probabilities(features, proj44,
                                               neighbor_ids, train, ref_ids)
        half = features.shape[0] // 2
        parts = [super(SplitBatchNormSweep, self).depth_probabilities(
            features, proj44, neighbor_ids, train, jnp.arange(i, i + half))
            for i in (0, half)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))


def jax_state(cfg, tree):
    """A JAX train state of ``tree`` whose optimizer records each step's
    gradients (its first stage), and the optimizer."""
    tx = optax.chain(grad_recorder(), jx_build_optimizer(
        cfg.optim, tree["params"], steps_per_epoch=1))
    return JxTrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                        batch_stats=tree["batch_stats"], frozen=tree["frozen"],
                        opt_state=tx.init(tree["params"])), tx


def jax_results(metrics, new):
    """(metrics, the step's gradients, the variables after it) on the
    host, under the port's names."""
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return ({k: float(v) for k, v in metrics.items()},
            flax_to_state_dict({"params": host(new.opt_state[0])}),
            flax_to_state_dict(host({"params": new.params,
                                     "batch_stats": new.batch_stats,
                                     "frozen": new.frozen})))


def jax_sharded_step(cfg, scenes, data, view, tree):
    """JAX `make_sharded_train_step` on a ``data x view`` mesh from
    ``tree``: `jax_results`."""
    model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)
    state, tx = jax_state(cfg, tree)
    stacked = {k: jnp.stack([jnp.asarray(s[k]) for s in scenes[:data]])
               for k in scenes[0]}
    mesh = jx_make_mesh(data, view)
    step = jx_sharded_step(model, tx, mesh, stacked)
    new, metrics = step(state, jx_shard_batch(stacked, mesh))
    return jax_results(metrics, new)


@pytest.fixture(scope="module")
def tmp_module(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel")


def sharded_case(name, tmp):
    """One case of CASES: the port's ranks, started first, then JAX in this
    process meanwhile.  Returns (`jax_results`, each rank's npz, JAX
    config, port config, scenes, tree, weights file)."""
    data, view, change, ark = CASES[name]
    cfg = change(train_config(tiny_test_config()))
    pcfg = change(train_config(port_config.tiny_test_config()))
    scenes = [make_synthetic_scene(cfg, seed=s, n_views=4, n_targets=2,
                                   arkit=ark) for s in range(data)]
    jx_model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)
    tree = random_variables(jx_model, {k: jnp.asarray(v)
                                       for k, v in scenes[0].items()},
                            method=JxMVSDet.loss)
    weights = save_weights(tmp / f"{name}.pt", pcfg, tree)
    out = tmp / name
    handle = ranks.start(ranks.train, data * view, out, data, view, pcfg,
                         weights, save_scenes(tmp / f"{name}.npz", scenes),
                         "gather")
    jx = jax_sharded_step(cfg, scenes, data, view, tree)
    handle.join()
    outs = [ranks.load(out, r) for r in range(data * view)]
    return jx, outs, cfg, pcfg, scenes, tree, weights


def noisy_elements(got, want) -> dict:
    """By variable, the elements of ``got`` further than STEP_TOL from
    ``want``'s."""
    return {name: int((np.abs(got[name] - value) > STEP_TOL).sum())
            for name, value in want.items()}


def check_step(jx, outs, grad_tol=None, noise=NOISE_ELEMENTS, lr=LR):
    """The port's step against JAX's: metrics, gradients (each leaf to
    ``grad_tol[name]``, else 1e-4 relative), parameters and statistics
    (at most ``noise`` elements past STEP_TOL), and every rank alike."""
    jx_metrics, jx_grads, jx_final = jx
    metrics = [{k[len("metric/"):]: float(v) for k, v in o.items()
                if k.startswith("metric/")} for o in outs]
    got = metrics[0]
    assert set(got) == set(jx_metrics)
    assert got["n_pos"] == jx_metrics["n_pos"] > 0
    for key, value in jx_metrics.items():
        assert abs(got[key] - value) <= 1e-4 * abs(value), key
    assert all(m == got for m in metrics[1:])
    assert len({str(o["digest"]) for o in outs}) == 1
    # rank 0 alone writes `fit`'s checkpoint
    assert [int(o["saves"]) for o in outs] == [1] + [0] * (len(outs) - 1)
    state = outs[0]
    for name, want in jx_grads.items():
        if f"grad/{name}" not in state:   # frozen, or FPN levels 1-3
            assert not np.any(want), name
            continue
        tol = max(1e-4, (grad_tol or {}).get(name, 0.0))
        assert rel(state[f"grad/{name}"], want) <= tol, name
    assert "grad/fpn.lateral0.weight" in state
    mine = {name: state[f"state/{name}"] for name in jx_final}
    for name, want in jx_final.items():
        diff = np.abs(mine[name] - want)
        assert diff.max() <= 3 * lr, (name, float(diff.max()))
    noisy = {k: v for k, v in noisy_elements(mine, jx_final).items() if v}
    assert sum(noisy.values()) <= noise, noisy
    return state


# -- (a) the mesh -------------------------------------------------------------

def test_make_mesh_layout(tmp_path):
    outs = ranks.run(ranks.mesh_layout, 4, tmp_path, 2, 2)
    for rank, out in enumerate(outs):
        d, v = divmod(rank, 2)
        assert list(out["index"]) == [d, v]
        assert list(out["view_ranks"]) == [2 * d, 2 * d + 1]
        assert list(out["data_ranks"]) == [v, v + 2]
    assert port_mesh.layout(2, 3) == [[0, 1, 2], [3, 4, 5]]


def test_make_mesh_needs_the_world_size(tmp_path):
    """As `make_mesh` of the JAX package refuses more devices than there
    are (tests/test_parallel.py:44-50); one rank here."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        mesh = port_mesh.make_mesh(1, 1)
        assert (mesh.data_index, mesh.view_index, mesh.rank) == (0, 0, 0)
        for data, view in ((2, 1), (1, 2), (8, 4)):
            with pytest.raises(ValueError, match="ranks"):
                port_mesh.make_mesh(data, view)
    finally:
        torch.distributed.destroy_process_group()


# -- (b) the collectives ------------------------------------------------------

def test_collectives_match_shard_map(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 4).astype(np.float32)
    w = rng.randn(6, 4).astype(np.float32)
    v = rng.randn(3, 4).astype(np.float32)
    handle = ranks.start(ranks.collectives, 2, tmp_path, x, w, v)

    def per_device(x, w, v):
        def f(x, w, v):
            s = jax.lax.psum(x * x, "view")
            g = jax.lax.all_gather(x, "view", axis=0, tiled=True)
            return jnp.sum(w * jnp.sin(g)) + jnp.sum(v * s * s)

        loss, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(x, w, v)
        return loss[None], grads[0], grads[1][None], grads[2][None]

    fn = jax.jit(shard_map(per_device, mesh=jx_make_mesh(1, 2),
                           in_specs=(P("view"), P(), P()),
                           out_specs=(P("view"),) * 4, check_vma=False))
    loss, gx, gw, gv = map(np.asarray, fn(x, w, v))
    handle.join()
    for r, out in enumerate(ranks.load(tmp_path, r) for r in range(2)):
        np.testing.assert_allclose(out["loss"], loss[r], rtol=1e-6)
        np.testing.assert_allclose(out["gx"], gx[3 * r:3 * r + 3],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["gw"], gw[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["gv"], gv[r], rtol=1e-6, atol=1e-6)
    # the transposes sum over the 2 ranks, each of which computes the
    # whole loss: d/dx_r = 2 w_r cos(x_r) + 2 * 2 v s * 2 x_r
    s = x[:3] ** 2 + x[3:] ** 2
    for r in range(2):
        xr, wr = x[3 * r:3 * r + 3], w[3 * r:3 * r + 3]
        np.testing.assert_allclose(gx[3 * r:3 * r + 3],
                                   2 * wr * np.cos(xr) + 8 * v * s * xr,
                                   rtol=1e-5, atol=1e-5)


# -- (c)-(f) one sharded step -------------------------------------------------

@pytest.mark.parametrize("name", ["data2", "arkit_data2", "data2_view2"])
def test_sharded_step_matches_jax(name, tmp_module):
    jx, outs, *_ = sharded_case(name, tmp_module)
    state = check_step(jx, outs)
    # the neck's running statistics moved, averaged over the scenes
    assert np.any(state["state/neck3d.out0.norm.running_var"] != 1.0)


def test_view_sharded_step_matches_jax_and_the_unsharded_gradients(
        tmp_module):
    jx, outs, _, pcfg, scenes, _, weights = sharded_case("view2", tmp_module)
    check_step(jx, outs)
    model = MVSDet(pcfg.model, sweep_chunk=2, sweep_method="gather").train()
    model.load_state_dict(torch.load(weights, weights_only=True))
    total, aux = model.loss({k: torch.from_numpy(v)
                             for k, v in scenes[0].items()})
    total.backward()
    want = {k: p.grad for k, p in model.named_parameters()
            if p.grad is not None}
    got = {k[len("grad/"):]: v for k, v in outs[0].items()
           if k.startswith("grad/")}
    assert set(got) == set(want) and "backbone.layer2_block0.conv1.weight" \
        in got
    for name, value in want.items():
        assert rel(got[name], value.numpy()) <= 1e-4, name
    assert float(outs[0]["metric/loss"]) == pytest.approx(total.item(),
                                                          rel=1e-5)


def batch_norm_case(tmp):
    """The BatchNorm view-2 case and its witness, JAX's unsharded step with
    the same two-view chunks: (`sharded_case`'s JAX results and ranks'
    npz, the witness's gradient distance from JAX's sharded step per leaf,
    its elements past STEP_TOL after the step)."""
    jx, outs, cfg, _, scenes, tree, _ = sharded_case("batch_norm_view2", tmp)
    model = SplitBatchNormSweep(cfg.model, sweep_method="gather",
                                sweep_chunk=2)
    state, tx = jax_state(cfg, tree)
    new, metrics = jax.jit(lambda s, b: jx_train_step(model, tx, s, b))(
        state, {k: jnp.asarray(v) for k, v in scenes[0].items()})
    _, w_grads, w_final = jax_results(metrics, new)
    witness = {k: rel(w_grads[k], v) for k, v in jx[1].items() if np.any(v)}
    return jx, outs, witness, sum(noisy_elements(w_final, jx[2]).values())


def test_batch_norm_view_sharded_step_matches_jax(tmp_module):
    jx, outs, witness, w_noise = batch_norm_case(tmp_module)
    assert max(witness.values()) > 1e-3   # the noise the tolerance covers
    state = check_step(jx, outs,
                       grad_tol={k: 2 * v for k, v in witness.items()},
                       noise=NOISE_ELEMENTS + 2 * w_noise)
    # CostRegNet's statistics: each rank's two views, then averaged
    assert np.any(state["state/cost_reg.conv0.norm.running_mean"] != 0.0)


# -- (g) the sharded evaluation -----------------------------------------------

def spanning(cfg):
    """A config of either package whose 8x8x4 voxels of 0.4 m span the
    synthetic scenes' spheres (the fixture's grid in
    tests/test_torch_port_launchers.py)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        narrow(cfg).model, voxel_size=(0.4, 0.4, 0.4)))


def test_sharded_evaluation_matches_one_scene_at_a_time_and_jax(tmp_path):
    cfg = spanning(tiny_test_config())
    pcfg = spanning(port_config.tiny_test_config())
    scenes = [make_synthetic_scene(cfg, seed=10 + s, n_views=4, n_targets=1)
              for s in range(3)]
    jx_model = JxMVSDet(cfg.model, sweep_method="gather")
    variables = random_variables(jx_model, {k: jnp.asarray(v) for k, v in
                                            scenes[0].items()},
                                 method=JxMVSDet.predict)
    detecting_head(variables["params"]["head"], scenes)
    weights = save_weights(tmp_path / "weights.pt", pcfg, variables)
    out = tmp_path / "ranks"
    handle = ranks.start(ranks.predict, 2, out, pcfg, weights,
                         save_scenes(tmp_path / "scenes.npz", scenes), 2,
                         False, "gather")
    n_classes = cfg.model.head.n_classes
    want = jx_harness.evaluate_scenes(
        jx_harness.make_sharded_predict_fn(jx_model, variables,
                                           jx_make_mesh(2, 1)),
        scenes, num_classes=n_classes, group_size=2)

    model = MVSDet(pcfg.model, sweep_method="gather")
    load_flax_variables(model, variables)
    predict = make_predict_fn(model, "cpu")
    single = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' thread count: equal sums
    try:
        one = evaluate_scenes(lambda b: single.append(predict(b)) or
                              single[-1], scenes, n_classes, device="cpu")
    finally:
        torch.set_num_threads(threads)
    handle.join()
    outs = [ranks.load(out, r) for r in range(2)]

    timing = ("predict_s_first", "predict_s_per_scene")
    metrics = [{k[len("metric/"):]: float(v) for k, v in o.items()
                if k.startswith("metric/")} for o in outs]
    got = metrics[0]
    assert {k: v for k, v in metrics[1].items() if k not in timing} == \
        {k: v for k, v in got.items() if k not in timing}
    assert set(got) == set(one) and set(got) - set(timing) == \
        set(want) - set(timing)
    for key in set(one) - set(timing):
        assert got[key] == one[key], key
    aps = [k for k in want if k.startswith(("AP_", "mAP_", "mAR_"))]
    assert want["mAP_0.25"] > 0, "the comparison would hold trivially"
    for key in aps:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    for key in ("psnr", "ssim"):
        assert got[key] == pytest.approx(want[key], rel=1e-4)
    # each scene's prediction, the padded copy of scene 2 dropped
    for s, pred in enumerate(single):
        for key, value in pred.items():
            np.testing.assert_array_equal(
                outs[0][f"pred/{s // 2}/{key}"][s % 2], value,
                err_msg=f"scene {s} {key}")
    np.testing.assert_array_equal(outs[0]["pred/1/boxes"][1],
                                  outs[0]["pred/1/boxes"][0])


# -- (h) depth supervision with the views sharded ----------------------------

def depth_supervised(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, depth_supervision=True))


def test_depth_supervision_with_sharded_views_is_refused(tmp_path):
    pcfg = depth_supervised(train_config(port_config.tiny_test_config()))
    with pytest.raises(ValueError, match="depth_supervision"):
        train_launcher.train(pcfg, train_launcher.parse_args(
            ["--tiny", "--synthetic", "1", "--view-parallel", "2",
             "--device", "cpu", "--work-dir", str(tmp_path)]))
    state = create_train_state(pcfg, device="cpu", sweep_chunk=2,
                               sweep_method="gather")
    mesh = port_mesh.Mesh(data=1, view=2, rank=0, data_index=0,
                          view_index=0, view_group=None, data_group=None,
                          world_group=None)
    with pytest.raises(ValueError, match="depth_supervision"):
        make_sharded_train_step(state, mesh)
    assert "depth_supervision" in DEPTH_SUPERVISION_SHARDED
    # JAX: the 2 shard's depth maps against all 4 views' estimates
    cfg = depth_supervised(train_config(tiny_test_config()))
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_sharded_step(cfg, [scene], 1, 2, random_variables(
            JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2),
            {k: jnp.asarray(v) for k, v in scene.items()},
            method=JxMVSDet.loss))


if __name__ == "__main__":
    # What JAX's sharded step computes with `depth_supervision` on, 4
    # views split over 2 and over 4 view ranks, beside the unsharded loss,
    # and the BatchNorm view-2 case's spreads (ROADMAP §3), on 8 virtual
    # CPU devices as conftest makes them:
    #   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    #       PYTHONPATH=.:tests python tests/test_torch_port_parallel.py
    import json
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        jx, outs, witness, w_noise = batch_norm_case(Path(tmp))
        port = {k: rel(outs[0][f"grad/{k}"], v) for k, v in jx[1].items()
                if f"grad/{k}" in outs[0]}
        mine = {k: outs[0][f"state/{k}"] for k in jx[2]}
        print(json.dumps({"batch_norm_view2": {
            "jax_split_vs_jax_sharded_grad_max_rel": float(
                max(witness.values())),
            "port_vs_jax_sharded_grad_max_rel": float(max(port.values())),
            "jax_split_vs_jax_sharded_elements_past_1e-6": w_noise,
            "port_vs_jax_sharded_elements_past_1e-6": sum(
                noisy_elements(mine, jx[2]).values())}}), flush=True)

    cfg = depth_supervised(train_config(tiny_test_config()))
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=1)
    model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=1)
    tree = random_variables(model, {k: jnp.asarray(v) for k, v in
                                    scene.items()}, method=JxMVSDet.loss)
    (_, aux), _ = model.apply(tree, scene, method=JxMVSDet.loss,
                              mutable=["batch_stats"])
    print(json.dumps({"unsharded": {k: float(v) for k, v in aux.items()}}))
    for view in (2, 4):
        try:
            metrics, _ = jax_sharded_step(cfg, [scene], 1, view, tree)
            print(json.dumps({f"view{view}": metrics}))
        except TypeError as exc:
            print(json.dumps({f"view{view}": f"TypeError: {exc}"}))
