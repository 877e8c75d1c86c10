"""`python -m mvsdet_torch.tools.overfit_map` on the CPU at 2 steps, an
evaluation after each, 1 scene, for MVSDet and NeRF-Det: its records
carry the keys of the JAX package's `scripts/overfit_map.py`, at its
cadence, and it ends with the summary line; without `--device cpu` it
needs the card.  The learning itself is `tests/test_torch_port_learning.py`
(slow) and `chip_smoke.py`'s `overfit_map` phase."""

import json
import math

import pytest
import torch

from mvsdet_torch.tools import overfit_map

EVAL_KEYS = {"step", "t", "mAP_0.25", "mAP_0.50", "mAR_0.25", "psnr"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread: beside the other test workers the CPU is oversubscribed
    (see tests/test_torch_port_launchers.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model", ["mvsdet", "nerfdet"])
def test_overfit_map_records_and_summary(model, capsys, tmp_path):
    history = overfit_map.main([
        "--device", "cpu", "--steps", "2", "--eval-every", "1", "--scenes",
        "1", "--model", model, "--out", str(tmp_path)])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    evals = [r for r in lines if "mAP_0.25" in r]
    assert evals == history and [r["step"] for r in evals] == [0, 1, 2]
    assert all(set(r) == EVAL_KEYS for r in evals)
    # the loss every 25 steps: at step 0 here
    assert [r for r in lines if "loss" in r] == [
        {"step": 0, "loss": lines[1]["loss"]}]
    assert lines[-1] == {"summary": {
        "first_mAP_0.25": evals[0]["mAP_0.25"],
        "last_mAP_0.25": evals[-1]["mAP_0.25"]}}
    with open(tmp_path / "overfit_log.jsonl") as f:
        assert [json.loads(line) for line in f] == lines
    # MVSDet scores its rendered views (the PSNR falls below 0 where a
    # step's colours are off by more than 1), NeRF-Det renders none
    psnr = [r["psnr"] for r in evals]
    assert (all(math.isfinite(p) and p != 0 for p in psnr)
            if model == "mvsdet" else psnr == [0.0] * 3)


def test_overfit_config_covers_the_scene_and_scales_the_milestones():
    cfg = overfit_map.overfit_config(lr=1e-3, arkit=True, total_steps=150)
    assert cfg.model.n_voxels == (16, 16, 8)
    assert cfg.model.voxel_size == (0.2, 0.2, 0.2)
    assert cfg.model.head.with_yaw and cfg.model.head.n_reg_outs == 7
    assert cfg.optim.milestones == (100, 137) and cfg.optim.lr == 1e-3
    assert overfit_map.overfit_config().optim.milestones == (10_000_000,)


def test_overfit_map_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert overfit_map.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overfit_map.main(["--steps", "1"])
