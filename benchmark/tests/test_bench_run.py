"""A run of the benchmark: the command fails with no card, the import
check compares whole top-level names, and a whole run at the cells'
small sizes on the CPU (the look for a card skipped) comes out correct
while each fault a cell can have, planted under the timed path, makes
`correct` come out false."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_values

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def test_a_run_with_no_card_fails_and_prints_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "scannet_train", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("mvsdet_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mvsdet_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "mvsdet_tpu"]


def run_small(cell: str, fault=None, **traffic) -> dict:
    arkit = cell.startswith("arkit")
    # at these sizes the head's few large random boxes leave a handful
    # after the NMS, where the cells' sizes keep about 256
    line = harness.run(cell, 2**31 + 77, 2.0, False, time.perf_counter(),
                       device="cpu", values=tiny_values(arkit), fault=fault,
                       traffic=dict({"check_min_kept": 4}, **traffic))
    json.dumps(line, allow_nan=False)
    assert list(line) == KEYS
    return line


@pytest.mark.parametrize("cell", ["scannet_train", "scannet_predict",
                                  "arkit_predict"])
def test_a_sound_run_is_correct(cell):
    line = run_small(cell)
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) >= {"setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("cell,fault", [
    ("scannet_train", "unchanged"), ("scannet_train", "half_batch"),
    ("scannet_predict", "half_batch"), ("scannet_predict", "altered"),
    ("arkit_predict", "half_batch"), ("arkit_predict", "altered")])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    line = run_small(cell, fault)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("cell", ["scannet_predict", "arkit_predict"])
def test_a_predict_that_keeps_too_few_boxes_is_not_correct(cell):
    # weights that score every point far below the threshold: no box
    line = run_small(cell, class_bias=-30.0)
    assert line["check"]["few_boxes"]["value"] == 3.0
    assert not line["correct"], line["check"]
