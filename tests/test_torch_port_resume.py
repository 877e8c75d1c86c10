"""A resumed real-data training run takes up the seeded scene stream where
an unbroken run stands, and keeps the best checkpoint it already has.

On the real-format ScanNet fixture (2 scenes of 12 frames, converted by
`tools/prepare_infos.py`) with `tiny_test_config()` on the CPU:

- `ScenePipeline.sample` + `load` give the batches that the JAX
  package's `ScenePipeline.__call__` (the port's `__call__` before the
  split) gives, and leave the rng where it leaves it, train and eval,
  over a run of scenes;
- `scene_iterator(start=, stride=)` yields the stream's batches at those
  positions, decoding no other scene's images: a resumed run starts at
  step k's position, data row d of D takes positions k * D + d;
- the train launcher cut after step 1 and resumed to step 4 sees, at
  each later step, the images, labels, boxes and origin an unbroken
  4-step run sees.  `fit` is replaced by a stub that records a digest of
  each batch and counts the step, and the train state holds a one-weight
  model, so no model runs; the checkpoints, the resume and the stream are
  the launcher's own;
- a resumed run whose evaluation scores below the best already saved
  leaves `best` as it was, and one that scores above replaces it; a
  fresh run in a used work dir saves its own `best` at its first
  evaluation, whatever an earlier run there scored.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fixtures.scannet_fixture import make_raw_fixture

from mvsdet_tpu.config import tiny_test_config as jx_tiny_test_config
from mvsdet_tpu.data import pipeline as jx_pipeline

from mvsdet_torch.config import tiny_test_config
from mvsdet_torch.data import pipeline
from mvsdet_torch.data.infos import load_infos
from mvsdet_torch.tools import train as train_launcher
from mvsdet_torch.training.loop import TrainState

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fixture_infos(tmp_path_factory):
    """(data root, converted infos pkl) of a 2-scene, 12-frame ScanNet
    fixture."""
    root = str(tmp_path_factory.mktemp("scannet"))
    raw = make_raw_fixture(root, n_scenes=2, n_frames=12)
    out = os.path.join(root, "converted")
    res = subprocess.run(
        [sys.executable, str(REPO / "tools" / "prepare_infos.py"),
         "--input", raw, "--out-dir", out],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return root, os.path.join(out, "scannet_infos_train.pkl")


def jx_cv2_rgb(path, hw):
    return jx_pipeline._imresize(jx_pipeline._imread_rgb(path), hw)


def digest(batch) -> str:
    """md5 of what a step trains on: the images, the GT and the origin."""
    h = hashlib.md5()
    for key in ("images", "gt_images", "gt_boxes", "gt_labels", "gt_mask",
                "origin", "w2c"):
        h.update(np.ascontiguousarray(batch[key]).tobytes())
    return h.hexdigest()


class CountingLoader:
    """cv2's image loader, counting the images it decodes."""

    def __init__(self):
        self.paths = []

    def __call__(self, path, hw):
        self.paths.append(path)
        return pipeline.cv2_load_rgb(path, hw)


@pytest.mark.parametrize("training", [True, False])
def test_sample_then_load_equals_the_whole_call(fixture_infos, training):
    root, pkl = fixture_infos
    cfg = tiny_test_config()
    scenes = load_infos(pkl, root, cfg.data.classes)
    port = pipeline.ScenePipeline(cfg, training=training,
                                  image_loader=pipeline.cv2_load_rgb)
    jx = jx_pipeline.ScenePipeline(jx_tiny_test_config(), training=training,
                                   image_loader=jx_cv2_rgb)
    rng_port, rng_jx = np.random.RandomState(11), np.random.RandomState(11)
    for i in range(6):
        scene = scenes[i % len(scenes)]
        plan = port.sample(scene, rng_port)
        got = port.load(scene, plan)
        want = jx(scene, rng_jx)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        np.testing.assert_array_equal(plan.origin, want["origin"])
    # the same draws in the same order: the streams stay in step
    assert rng_port.randint(1 << 30) == rng_jx.randint(1 << 30)


@pytest.mark.parametrize("start,stride", [(0, 1), (3, 1), (0, 2), (1, 2),
                                          (5, 3)])
def test_scene_iterator_takes_its_positions_and_decodes_them_alone(
        fixture_infos, start, stride):
    root, pkl = fixture_infos
    cfg = tiny_test_config()
    scenes = load_infos(pkl, root, cfg.data.classes)
    whole = list(pipeline.scene_iterator(
        scenes, pipeline.ScenePipeline(cfg,
                                       image_loader=pipeline.cv2_load_rgb),
        seed=3, repeat=4))
    loader = CountingLoader()
    got = list(pipeline.scene_iterator(
        scenes, pipeline.ScenePipeline(cfg, image_loader=loader), seed=3,
        repeat=4, start=start, stride=stride))
    want = whole[start::stride]
    assert len(whole) == 8 and len(got) == len(want) > 0
    assert [digest(b) for b in got] == [digest(b) for b in want]
    per_batch = cfg.data.n_views_train       # sources and targets
    assert len(loader.paths) == per_batch * len(got)


@pytest.fixture
def small_state(monkeypatch):
    """The launcher's train state with a one-weight model in place of
    MVSDet: its checkpoints still carry the step."""
    def create(cfg, device="cpu", **kwargs):
        model = torch.nn.Linear(1, 1)
        optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
        return TrainState(model, optimizer,
                          torch.optim.lr_scheduler.StepLR(optimizer, 1),
                          max_norm=1.0)
    monkeypatch.setattr(train_launcher, "create_train_state", create)


def stub_fit(seen):
    """`fit` without a model: records each batch's digest at its step and
    counts the step."""
    def fit(state, batches, num_steps, **kwargs):
        for batch in batches:
            seen.append((state.step, digest(batch)))
            state.step += 1
        assert state.step > 0
        return state
    return fit


def train(cfg, pkl, root, work, *flags):
    return train_launcher.train(cfg, train_launcher.parse_args(
        ["--infos", pkl, "--data-root", root, "--work-dir", str(work),
         "--device", "cpu", *flags]))


def records(work):
    with open(os.path.join(work, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resumed_run_sees_the_unbroken_runs_batches(fixture_infos, tmp_path,
                                                     monkeypatch, small_state):
    root, pkl = fixture_infos
    cfg = tiny_test_config()
    whole, cut = [], []
    monkeypatch.setattr(train_launcher, "fit", stub_fit(whole))
    train(cfg, pkl, root, tmp_path / "whole", "--steps", "4")
    monkeypatch.setattr(train_launcher, "fit", stub_fit(cut))
    train(cfg, pkl, root, tmp_path / "cut", "--steps", "1")
    state = train(cfg, pkl, root, tmp_path / "cut", "--steps", "4",
                  "--resume", str(tmp_path / "cut" / "latest"))
    assert state.step == 4
    assert [s for s, _ in whole] == [s for s, _ in cut] == [0, 1, 2, 3]
    assert len({d for _, d in whole}) > 2, "the stream does not vary"
    assert cut == whole


def test_resumed_run_keeps_a_better_best(fixture_infos, tmp_path,
                                         monkeypatch, small_state):
    root, pkl = fixture_infos
    cfg = tiny_test_config()
    work = tmp_path / "work"
    scores = iter([0.5, 0.3, 0.7])
    monkeypatch.setattr(train_launcher, "fit", stub_fit([]))
    monkeypatch.setattr(train_launcher, "evaluate_scenes",
                        lambda *a, **k: {"mAP_0.25": next(scores)})
    val = ["--val-infos", pkl, "--val-max-scenes", "1"]

    def best_digest():
        return hashlib.md5((work / "best").read_bytes()).hexdigest()

    def saves(log):
        return [(r["saved"], r["step"]) for r in log if "saved" in r]

    train(cfg, pkl, root, work, "--steps", "1", *val)
    first = records(work)
    assert saves(first) == [("latest", 0), ("best", 0)]
    saved = best_digest()
    train(cfg, pkl, root, work, "--steps", "2", "--resume",
          str(work / "latest"), *val)
    second = records(work)[len(first):]
    assert [r["eval"]["mAP_0.25"] for r in second if "eval" in r] == [0.3]
    assert saves(second) == [("latest", 1)]
    assert best_digest() == saved
    train(cfg, pkl, root, work, "--steps", "3", "--resume",
          str(work / "latest"), *val)
    third = records(work)[len(first) + len(second):]
    assert saves(third) == [("latest", 2), ("best", 2)]
    assert best_digest() != saved


def test_fresh_run_in_a_used_work_dir_saves_its_own_best(
        fixture_infos, tmp_path, monkeypatch, small_state):
    root, pkl = fixture_infos
    cfg = tiny_test_config()
    work = tmp_path / "work"
    scores = iter([0.7, 0.3])
    monkeypatch.setattr(train_launcher, "fit", stub_fit([]))
    monkeypatch.setattr(train_launcher, "evaluate_scenes",
                        lambda *a, **k: {"mAP_0.25": next(scores)})
    val = ["--val-infos", pkl, "--val-max-scenes", "1"]
    train(cfg, pkl, root, work, "--steps", "1", *val)
    first = records(work)
    earlier = hashlib.md5((work / "best").read_bytes()).hexdigest()
    torch.manual_seed(1)              # another run's weights in `best`
    train(cfg, pkl, root, work, "--steps", "1", *val)
    second = records(work)[len(first):]
    assert [r["eval"]["mAP_0.25"] for r in second if "eval" in r] == [0.3]
    assert [(r["saved"], r["step"]) for r in second if "saved" in r] == [
        ("latest", 0), ("best", 0)]
    assert hashlib.md5((work / "best").read_bytes()).hexdigest() != earlier
