"""The frozen reference (`benchmark/reference/`) against the port's own
plain CPU path at `tiny_test_config()`: the same predict and the same
three training steps from the same seed-drawn weights, and no import of
the port."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, check, scenes
from benchmark.tests.conftest import tiny_values
from benchmark.weights import draw_weights, traffic_weights

ROOT = Path(__file__).resolve().parents[2]
TRAIN = traffic_weights(json.loads(
    (ROOT / "benchmark" / "traffic" / "train.json").read_text()))
PREDICT = traffic_weights(json.loads(
    (ROOT / "benchmark" / "traffic" / "predict.json").read_text()))


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys, benchmark.check, benchmark.flops, "
            "benchmark.reference.models.mvsdet, "
            "benchmark.reference.training.optim; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mvsdet_torch', 'mvsdet_tpu', 'jax', 'jaxlib', 'flax', "
            "'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("arkit", [False, True], ids=["scannet", "arkit"])
def test_predict_matches_the_port(arkit):
    from mvsdet_torch import config as port_config
    from mvsdet_torch.evaluation.harness import make_predict_fn
    from mvsdet_torch.models.mvsdet import MVSDet
    values = tiny_values(arkit)
    cfg = cells.build_config(port_config, values)
    batch = scenes.make_scene(cfg, 11, 5, 1, arkit, device="cpu")
    model = MVSDet(cfg.model)
    draw_weights(model, 3, **PREDICT)
    got = make_predict_fn(model.eval(), "cpu")(batch)
    want = check.reference_predict(values, 3, PREDICT, [batch], "cpu")[0]
    for k in ("boxes", "scores", "labels", "mask", "rendered",
              "depth_expect"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kept = int(got["mask"].sum())
    assert kept > 0
    assert check.judge_predict([got], [want], cfg.model.head, kept) == {
        "render_gap": 0.0, "depth_gap": 0.0, "few_boxes": 0.0,
        "box_misses": 0.0}


def test_three_steps_match_the_port():
    """The train mode's checked steps (one `fit` call, the first gradient
    read by the optimizer's hook), every step's losses logged."""
    from mvsdet_torch import config as port_config
    cell = cells.find_cell("scannet_train")
    train = cells.load_mode(cell)
    values = tiny_values()
    cfg = cells.build_config(port_config, values)
    pool = scenes.make_pool(cfg, 5, 3, 5, 2, False, device="cpu")
    state = train.build_train(cfg, 4, TRAIN, "cpu")
    prog = train.checked_steps(state, dict(cell.traffic, log_every=1), pool)
    ref = check.reference_train(values, 4, TRAIN, pool, "cpu")
    assert sorted(prog["losses"]) == [0, 1, 2]
    for i, want in enumerate(ref["losses"]):
        assert prog["losses"][i] == pytest.approx(want, rel=1e-5, abs=1e-7)
    assert min(prog["grads"].values()) >= 0.0 \
        and max(prog["grads"].values()) > 0.0
    numbers = check.judge_train(prog, ref)
    # the CPU's convolutions split their sums over threads: 1e-4 of a norm
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-3 and numbers["update_gap"] < 1e-3


def test_weights_are_the_seeds():
    from benchmark.reference.models.mvsdet import MVSDet
    cfg = check.reference_config(tiny_values())
    a, b, c = MVSDet(cfg.model), MVSDet(cfg.model), MVSDet(cfg.model)
    draw_weights(a, 9, **TRAIN)
    draw_weights(b, 9, **TRAIN)
    draw_weights(c, 10, **TRAIN)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "cost_reg.conv0.conv.weight"
    assert not torch.equal(sa[w], sc[w])
    assert float(sa["head.conv_cls.bias"][0]) == pytest.approx(-4.595)
    # lecun-normal: the std of a kernel is fan_in ** -0.5 (cut at 2 sigma)
    fan_in = sa[w][0].numel()
    assert float(sa[w].std()) == pytest.approx(fan_in ** -0.5, rel=0.05)
