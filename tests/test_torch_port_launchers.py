"""The slice end to end: the real-format ScanNet fixture through the port's
launchers on the CPU, held against the JAX package.

- `mvsdet_torch.tools.test`'s `evaluate` on the two fixture scenes against
  JAX's `make_predict_fn` + `evaluate_scenes` on the JAX pipeline's
  batches, with the same weights (JAX's tree, carried across with
  `interop.load_flax_variables` into a checkpoint): equal mAPs and
  per-class APs (1e-6), psnr and ssim (1e-4 relative).
- `mvsdet_torch.tools.train` on the fixture: steps, `train_log.jsonl`,
  `latest`, `--resume`, the evaluation's `best`, and
  `create_predict_state` loading it bit-equal.
- `load_pretrained_backbone` on a torchvision-named state dict against
  the JAX package's `port_torchvision_state_dict`.
- The launchers under torchrun with `--data-parallel 2` on the CPU
  (gloo): `train` writes one log and one checkpoint, from rank 0, and its
  ranks end with equal parameters (bit for bit, also equal to that
  checkpoint's); `test` prints the metric dict of one process.
- `train --model nerfdet`: its steps, evaluations and checkpoints, a
  resumed run drawing the rays of an unbroken one, and a step in bf16.
- The launchers run on the card unless `--device cpu` is given, and
  refuse the options that wait for later parts of the port; the test
  launcher takes `--diagnostics`, and `--vis-dir` implies it
  (`tests/test_torch_port_diagnostics.py` runs them).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _parallel_ranks as ranks
from fixtures.scannet_fixture import make_raw_fixture

from mvsdet_tpu.config import tiny_test_config as jx_tiny_test_config
from mvsdet_tpu.data.infos import load_infos as jx_load_infos
from mvsdet_tpu.data.pipeline import ScenePipeline as JxScenePipeline
from mvsdet_tpu.evaluation import harness as jx_harness
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.models.resnet import ResNet50 as JxResNet50
from mvsdet_tpu.models.resnet import port_torchvision_state_dict

from mvsdet_torch.config import tiny_test_config
from mvsdet_torch.interop import load_flax_variables
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.tools import test as test_launcher
from mvsdet_torch.tools import train as train_launcher
from mvsdet_torch.training.loop import (create_nerfdet_state,
                                        create_predict_state,
                                        create_train_state,
                                        load_pretrained_backbone)

from test_torch_port_interop import narrow, random_variables

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This file's torch work on one thread: beside the other test workers
    the CPU is oversubscribed, and every split op then waits for threads
    that are not running (a training step took minutes on 8 threads and
    seconds on 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def fixture_config(cfg):
    """A `tiny_test_config()` (of either package) whose 8x8x4 voxels of
    0.4 m span the fixture's room and whose head has its 18 classes."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, voxel_size=(0.4, 0.4, 0.4),
        head=dataclasses.replace(cfg.model.head, n_classes=18)))


def detecting_head(head, scenes):
    """Random weights give boxes of zero or metres in size and random
    classes, so an mAP of 0, which any two predicts would agree on.  Here
    every distance is exp(0.05 * conv_reg(x)) with conv_reg's kernel
    negative (the neck's output is a ReLU's), boxes of about 0.6 m, and
    the class of most GT boxes leads every voxel's logits, with the
    random kernel's small share left to order the scores."""
    head["conv_reg"]["kernel"] = -np.abs(head["conv_reg"]["kernel"])
    head["scales"] = np.full_like(head["scales"], 0.05)
    labels = np.concatenate([s["gt_labels"][s["gt_mask"]] for s in scenes])
    bias = np.full_like(head["conv_cls"]["bias"], -6.0)
    bias[np.bincount(labels).argmax()] = 1.0
    head["conv_cls"]["bias"] = bias
    head["conv_cls"]["kernel"] = head["conv_cls"]["kernel"] * np.float32(0.05)


@pytest.fixture(scope="module")
def jax_eval(fixture_infos, tmp_path_factory):
    """JAX's metric dict on the fixture, and a port checkpoint of the same
    weights."""
    root, pkl = fixture_infos
    cfg = fixture_config(jx_tiny_test_config())
    scenes = [JxScenePipeline(cfg, training=False)(
        info, np.random.RandomState(i))
        for i, info in enumerate(jx_load_infos(pkl, root, cfg.data.classes))]
    model = JxMVSDet(cfg.model)
    batch = {k: jnp.asarray(v) for k, v in scenes[0].items()}
    variables = random_variables(model, batch, method=JxMVSDet.predict)
    detecting_head(variables["params"]["head"], scenes)
    want = jx_harness.evaluate_scenes(
        jx_harness.make_predict_fn(model, variables), scenes,
        num_classes=cfg.model.head.n_classes)
    port = MVSDet(fixture_config(tiny_test_config()).model)
    load_flax_variables(port, variables)
    checkpoint = str(tmp_path_factory.mktemp("ckpt") / "jax_weights")
    torch.save({"model": port.state_dict()}, checkpoint)
    return want, checkpoint


def test_test_launcher_matches_jax_on_the_fixture(fixture_infos, jax_eval):
    root, pkl = fixture_infos
    want, checkpoint = jax_eval
    args = test_launcher.parse_args(
        ["--infos", pkl, "--data-root", root, "--checkpoint", checkpoint,
         "--device", "cpu"])
    got = test_launcher.evaluate(fixture_config(tiny_test_config()), args)
    assert set(got) == set(want)
    aps = [k for k in want if k.startswith(("AP_", "mAP_", "mAR_"))]
    assert "mAP_0.25" in aps and "mAP_0.50" in aps and len(aps) > 4
    for key in aps:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    for key in ("psnr", "ssim"):
        assert got[key] == pytest.approx(want[key], rel=1e-4)
    assert want["mAP_0.25"] > 0, "the comparison would hold trivially"
    assert got["predict_s_first"] > 0 and got["predict_s_per_scene"] > 0


def records(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def frozen_backbone(cfg):
    """``cfg`` with every ResNet stage frozen: the launcher's steps then
    run no backward through the ResNet-50, which the training tests
    hold, and stay cheap on a loaded CPU."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone,
                                                frozen_stages=4)))


def test_train_launcher_on_the_fixture(fixture_infos, tmp_path):
    root, pkl = fixture_infos
    cfg = frozen_backbone(narrow(tiny_test_config()))
    work = str(tmp_path / "work")
    common = ["--infos", pkl, "--data-root", root, "--work-dir", work,
              "--device", "cpu", "--log-every", "1"]
    state = train_launcher.train(cfg, train_launcher.parse_args(
        common + ["--steps", "3", "--val-infos", pkl,
                  "--val-max-scenes", "1"]))
    log = records(work)
    steps = [r for r in log if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    evals = [r["eval"] for r in log if "eval" in r]
    assert len(evals) == 1 and "mAP_0.25" in evals[0]
    assert [r["saved"] for r in log if "saved" in r] == ["latest", "best"]
    assert state.step == 3

    # the predict state loads the trained weights bit for bit
    model = create_predict_state(cfg, os.path.join(work, "best"),
                                 device="cpu")
    trained = state.model.state_dict()
    assert not model.training
    for key, value in model.state_dict().items():
        assert torch.equal(value, trained[key]), key

    # --resume continues at the checkpoint's step
    state = train_launcher.train(cfg, train_launcher.parse_args(
        common + ["--steps", "4", "--resume",
                  os.path.join(work, "latest")]))
    resumed = [r for r in records(work)[len(log):] if "loss" in r]
    assert [r["step"] for r in resumed] == [3] and state.step == 4


def nerfdet_args(work, *flags):
    return train_launcher.parse_args(
        ["--model", "nerfdet", "--tiny", "--synthetic", "1", "--device", "cpu",
         "--work-dir", str(work), "--log-every", "1", *flags])


def test_train_launcher_nerfdet(tmp_path):
    """`--model nerfdet --tiny --synthetic 1 --steps 2 --val-synthetic 1
    --device cpu` (narrow widths, the ResNet frozen): two steps with every
    NeRF-Det loss term, an evaluation after each (an epoch is one scene),
    `latest` and `best`."""
    cfg = frozen_backbone(narrow(tiny_test_config()))
    state = train_launcher.train(cfg, nerfdet_args(
        tmp_path, "--steps", "2", "--val-synthetic", "1"))
    log = records(tmp_path)
    steps = [r for r in log if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        assert {"cls_loss", "loss_nvs", "loss_depth", "n_pos"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
        assert r["loss_nvs"] > 0
    evals = [r["eval"] for r in log if "eval" in r]
    assert len(evals) == 2 and all("mAP_0.25" in e and "predict_s_first" in e
                                   for e in evals)
    assert "psnr" not in evals[0]          # NeRF-Det renders no view
    assert [r["saved"] for r in log if "saved" in r][:2] == ["latest", "best"]
    assert sorted(os.listdir(tmp_path)) == ["best", "latest",
                                            "train_log.jsonl"]
    assert type(state.model).__name__ == "NerfDetLegacy" and state.step == 2


def test_train_launcher_nerfdet_resume_draws_as_unbroken(tmp_path,
                                                          monkeypatch):
    """A run resumed from `latest` at step 1 draws the rays an unbroken run
    draws at steps 1 and 2, and ends with the same losses."""
    from mvsdet_torch.models.nerfdet import NerfDetLegacy

    cfg = frozen_backbone(narrow(tiny_test_config()))
    drawn = []
    draw = NerfDetLegacy.draw_rays
    monkeypatch.setattr(NerfDetLegacy, "draw_rays",
                        lambda self, batch, g: drawn.append(
                            draw(self, batch, g)) or drawn[-1])
    train_launcher.train(cfg, nerfdet_args(tmp_path / "whole", "--steps", "3"))
    whole, drawn[:] = list(drawn), []
    train_launcher.train(cfg, nerfdet_args(tmp_path / "cut", "--steps", "1"))
    train_launcher.train(cfg, nerfdet_args(
        tmp_path / "cut", "--steps", "3", "--resume",
        str(tmp_path / "cut" / "latest")))
    assert len(whole) == len(drawn) == 3
    for a, b in zip(whole, drawn):
        for key in ("ts", "ys", "xs", "t"):
            assert torch.equal(a[key], b[key]), key
    assert not torch.equal(whole[1]["t"], whole[2]["t"])
    losses = [[r for r in records(tmp_path / run) if "loss" in r]
              for run in ("whole", "cut")]
    assert [r["step"] for r in losses[1]] == [0, 1, 2]
    for a, b in zip(losses[0], losses[1]):
        assert {k: v for k, v in a.items() if k != "time"} \
            == {k: v for k, v in b.items() if k != "time"}


def test_train_launcher_nerfdet_bf16(tmp_path):
    """`--model nerfdet --dtype bfloat16` is taken: one step of a NeRF-Det
    computing in bf16, its loss terms finite, its parameters float32."""
    cfg = frozen_backbone(narrow(tiny_test_config()))
    state = train_launcher.train(cfg, nerfdet_args(
        tmp_path, "--steps", "1", "--dtype", "bfloat16"))
    (step,) = [r for r in records(tmp_path) if "loss" in r]
    assert step["step"] == 0 and step["loss_nvs"] > 0
    assert all(np.isfinite(v) for v in step.values())
    assert state.model.dtype == torch.bfloat16 and state.step == 1
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}


def torchvision_state_dict(seed=0):
    """Random weights under torchvision's resnet50 names and shapes (its
    classifier included), written out here, not taken from the port."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name] = torch.randn(o, i, k, k, generator=g) * (i * k * k) ** -0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + 0.2 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.2 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = 0.3 * torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = 0.5 + 1.5 * torch.rand(c, generator=g)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for layer, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 6),
                                              (512, 3)), 1):
        for b in range(blocks):
            p = f"layer{layer}.{b}"
            conv(f"{p}.conv1.weight", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2.weight", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3.weight", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                conv(f"{p}.downsample.0.weight", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.fixture(scope="module")
def backbone_case():
    """(torchvision state dict, input, JAX stage outputs in NCHW)."""
    sd = torchvision_state_dict()
    ported = port_torchvision_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    x = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    outs = JxResNet50().apply(ported, jnp.asarray(x.transpose(0, 2, 3, 1)))
    return sd, x, [np.asarray(o).transpose(0, 3, 1, 2) for o in outs]


@pytest.fixture(scope="module")
def train_state():
    """One train state for the backbone tests (each checks what it loads
    or that a refused file changed nothing)."""
    return create_train_state(narrow(tiny_test_config()), device="cpu")


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_pretrained_backbone_matches_jax(backbone_case, train_state,
                                         tmp_path, suffix):
    sd, x, want = backbone_case
    path = str(tmp_path / f"resnet50{suffix}")
    if suffix == ".pth":
        torch.save({"state_dict": sd}, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    state = train_state
    head = state.model.head.conv_cls.weight.detach().clone()
    assert load_pretrained_backbone(state, path) is state
    assert torch.equal(state.model.backbone.stem_conv.weight,
                       sd["conv1.weight"])
    assert torch.equal(state.model.head.conv_cls.weight, head)
    with torch.no_grad():
        got = state.model.backbone(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, f"stage {i}: {err}"


def test_pretrained_backbone_loads_into_nerfdet(tmp_path):
    """`--pretrained` with `--model nerfdet`: the same loader fills a
    NeRF-Det state's ResNet and leaves the rest, `mapping` included."""
    sd = torchvision_state_dict(seed=2)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    state = create_nerfdet_state(narrow(tiny_test_config()), device="cpu")
    mapping = state.model.mapping.weight.detach().clone()
    assert load_pretrained_backbone(state, path) is state
    assert torch.equal(state.model.backbone.stem_conv.weight,
                       sd["conv1.weight"])
    assert torch.equal(state.model.backbone.layer4_block2.bn3.running_var,
                       sd["layer4.2.bn3.running_var"])
    assert torch.equal(state.model.mapping.weight, mapping)


@pytest.mark.parametrize("change", ["shape", "missing"])
def test_pretrained_backbone_mismatch_raises(train_state, tmp_path, change):
    sd = torchvision_state_dict(seed=1)
    if change == "shape":
        sd["layer2.1.conv2.weight"] = sd["layer2.1.conv2.weight"][:, :64]
    else:
        del sd["layer3.0.downsample.1.running_var"]
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    before = {k: v.clone() for k, v in
              train_state.model.backbone.state_dict().items()}
    with pytest.raises(ValueError):
        load_pretrained_backbone(train_state, path)
    for key, value in train_state.model.backbone.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_launchers_need_the_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launcher.main(["--tiny", "--synthetic", "1", "--steps", "1",
                             "--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_launcher.main(["--synthetic", "1"])
    assert train_launcher.parse_args([]).device == "cuda"
    assert test_launcher.parse_args([]).device == "cuda"


@pytest.mark.parametrize("launcher,flags", [
    (train_launcher, ["--model", "nerfdet", "--data-parallel", "2"])])
def test_launchers_refuse_what_waits_for_later_slices(launcher, flags):
    with pytest.raises(SystemExit):
        launcher.parse_args(flags)


@pytest.mark.parametrize("flags,diagnostics,vis_dir", [
    ([], False, None),
    (["--diagnostics"], True, None),
    (["--vis-dir", "out"], True, "out")])
def test_test_launcher_takes_the_diagnostics_flags(flags, diagnostics,
                                                   vis_dir):
    """`--vis-dir` implies the diagnostics, as tools/test.py:153 has it."""
    args = test_launcher.parse_args(flags)
    assert args.diagnostics is diagnostics and args.vis_dir == vis_dir


@pytest.mark.parametrize("launcher,flags", [
    (train_launcher, ["--data-parallel", "2"]),
    (train_launcher, ["--view-parallel", "2"]),
    (test_launcher, ["--data-parallel", "2"])])
def test_launchers_take_the_parallel_flags(launcher, flags):
    args = launcher.parse_args(flags)
    assert getattr(args, flags[0][2:].replace("-", "_")) == 2
    # outside a process group of that size they refuse to start
    with pytest.raises(ValueError, match="processes"):
        if launcher is train_launcher:
            launcher.train(tiny_test_config(), launcher.parse_args(
                flags + ["--tiny", "--synthetic", "1", "--device", "cpu"]))
        else:
            launcher.evaluate(tiny_test_config(), launcher.parse_args(
                flags + ["--synthetic", "1", "--device", "cpu"]))


TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2"]


def torchrun(program, args, cwd):
    """``program`` (``-m module`` or a script) under torchrun on 2
    processes on the CPU: its stdout."""
    res = subprocess.run(TORCHRUN + program + args, cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def test_train_launcher_data_parallel_under_torchrun(tmp_path):
    train_args = ["--tiny", "--synthetic", "2", "--steps", "2",
                  "--data-parallel", "2", "--device", "cpu",
                  "--log-every", "1"]
    # each process runs `mvsdet_torch.tools.train`'s main, then saves its
    # parameters' digest (torchrun's processes keep their states)
    work, out = tmp_path / "torchrun", tmp_path / "ranks"
    out.mkdir()
    stdout = torchrun([str(REPO / "tests" / "_parallel_ranks.py"), str(out)],
                      train_args + ["--work-dir", str(work)], tmp_path)
    log = records(work)
    assert log[0] == {"backend": "gloo", "world": 2, "data_parallel": 2,
                      "view_parallel": 1, "device": "cpu"}
    steps = [r for r in log if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    assert [r["saved"] for r in log if "saved" in r] == ["latest"]
    assert sorted(os.listdir(work)) == ["latest", "train_log.jsonl"]
    # rank 0 alone prints (and writes) the records
    assert stdout.count('"saved": "latest"') == 1
    digests = {str(ranks.load(out, r)["digest"]) for r in range(2)}
    assert len(digests) == 1 and int(ranks.load(out, 0)["step"]) == 2
    model = create_predict_state(tiny_test_config(), str(work / "latest"),
                                 device="cpu")
    assert ranks.params_digest(model) in digests


def test_test_launcher_data_parallel_matches_one_process(tmp_path):
    test_args = ["--tiny", "--synthetic", "3", "--device", "cpu"]
    stdout = torchrun(["-m", "mvsdet_torch.tools.test"],
                      test_args + ["--data-parallel", "2"], tmp_path)
    lines = [json.loads(line) for line in stdout.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1                 # rank 0's
    got = lines[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # torchrun's processes' count
    try:
        want = test_launcher.main(test_args)
    finally:
        torch.set_num_threads(threads)
    timing = {"predict_s_first", "predict_s_per_scene"}
    assert set(got) == set(want) and {"mAP_0.25", "psnr", "ssim"} <= set(got)
    for key in set(want) - timing:
        assert got[key] == want[key], key
