"""From the same initial weights the port's overfit is the JAX package's
own, on the CPU (slow lane).

The aligned case of `tests/test_learning.py` (150 steps, 2 scenes, lr
1e-3) at seeds 0, 1 and 2, run by JAX and by the port
(`mvsdet_torch.tools.overfit_map.run`, which draws JAX's initial weights
for the seed).  Both sweep with their default, the two-product shear
warp (`sweep_method="mxu"`), as JAX's `scripts/overfit_map.py` does:

- the first step's loss terms equal JAX's to 1e-5 relative and the
  positive count is JAX's: the port computes JAX's step from JAX's
  weights;
- every run climbs and holds (starts below 0.3, ends within 0.2 of its
  best), and the median over the seeds of the final mAP_0.25 and
  mAR_0.25 clears JAX's gate of 0.6 in both packages.

Later steps part by rounding (the overfit is chaotic); `-s` prints both
histories of each seed.
"""

import functools
import json
import os
import statistics
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.evaluation.harness import evaluate_scenes
from mvsdet_tpu.models.mvsdet import MVSDet
from mvsdet_tpu.training.loop import create_train_state, make_jitted_train_step

from mvsdet_torch.tools import overfit_map

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from overfit_map import overfit_config  # noqa: E402

pytestmark = pytest.mark.slow

STEPS, EVAL_EVERY, SEEDS = 150, 50, (0, 1, 2)


def jax_run(seed):
    """(history, first step's metrics) of JAX's default model."""
    cfg = overfit_config(lr=1e-3, total_steps=STEPS)
    scenes = [make_synthetic_scene(cfg, seed=seed + s, n_views=4,
                                   n_targets=2) for s in range(2)]
    batches = [{k: jnp.asarray(v) for k, v in s.items()} for s in scenes]
    model, state, tx = create_train_state(cfg, jax.random.PRNGKey(seed),
                                          batches[0], sweep_chunk=2,
                                          steps_per_epoch=1)
    assert model.sweep_method == "mxu"
    step = make_jitted_train_step(model, tx)
    predict = jax.jit(functools.partial(model.apply, method=MVSDet.predict),
                      static_argnums=(2,))
    history, first = [], None
    for i in range(STEPS + 1):
        if i % EVAL_EVERY == 0 or i == STEPS:
            variables = {"params": state.params,
                         "batch_stats": state.batch_stats,
                         "frozen": state.frozen}
            res = evaluate_scenes(lambda b: predict(variables, b, False),
                                  scenes, num_classes=cfg.model.head.n_classes)
            history.append({"step": i, "mAP_0.25": res["mAP_0.25"],
                            "mAR_0.25": res["mAR_0.25"]})
        if i == STEPS:
            break
        state, metrics = step(state, batches[i % 2])
        if first is None:
            first = {k: float(v) for k, v in metrics.items()}
    return history, first


def port_run(seed, monkeypatch):
    """(history, first step's metrics) of `overfit_map.run` on the CPU."""
    first = {}
    plain = overfit_map.step_fn

    def recording_step_fn(state):
        step = plain(state)

        def recorded(batch):
            metrics = step(batch)
            if not first:
                first.update({k: float(v) for k, v in metrics.items()})
            return metrics
        return recorded

    monkeypatch.setattr(overfit_map, "step_fn", recording_step_fn)
    history = overfit_map.run(STEPS, EVAL_EVERY, 2, 1e-3, seed,
                              log_fn=lambda line: None, device="cpu")
    return history, first


def test_port_overfits_as_jax_from_the_same_weights(monkeypatch):
    finals = {"jax": [], "port": []}
    for seed in SEEDS:
        jx_history, jx_first = jax_run(seed)
        history, first = port_run(seed, monkeypatch)
        print(json.dumps({"seed": seed, "jax": jx_history, "port": history,
                          "jax_step0": jx_first, "port_step0": first}))
        assert first["n_pos"] == jx_first["n_pos"], (first, jx_first)
        for key, want in jx_first.items():
            assert abs(first[key] - want) <= 1e-5 * abs(want), (key, first)
        for hist in (jx_history, history):
            best = max(h["mAP_0.25"] for h in hist)
            assert hist[0]["mAP_0.25"] < 0.3, hist
            assert hist[-1]["mAP_0.25"] >= best - 0.2, hist
        finals["jax"].append(jx_history[-1])
        finals["port"].append(history[-1])
    for name, runs in finals.items():
        for key in ("mAP_0.25", "mAR_0.25"):
            assert statistics.median(r[key] for r in runs) > 0.6, (name, runs)
