"""The port's diagnostics past the model: the harness's metrics and hook,
the test launcher's images and PLY, and the sharded predict.

- `evaluate_scenes` of the port and of the JAX package on the same fixed
  host predictions (no model compiles: both are handed a function that
  returns them): equal metric dicts, predict times aside (`depth_rmse`,
  `weight_gap`, `src_rmse` among them), and `vis_hook` called in scene
  order by both.
- `tools.test`'s `make_vis_hook` writes the files JAX's `tools/test.py`
  hook writes, byte for byte (PNGs and the PLY), for the same scene and
  prediction.
- The launcher on the CPU with `--diagnostics --vis-dir`.
- Two gloo ranks of `make_sharded_predict_fn(..., diagnostics=True)`:
  each scene's prediction and the metrics equal the single predict's.

The model's diagnostics themselves (rendered depth, `weight_gap`,
`src_rmse`, the flat Gaussians) are held against JAX in
`tests/test_torch_port_model.py`.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mvsdet_tpu.evaluation import harness as jx_harness

from mvsdet_torch.config import tiny_test_config
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import (evaluate_scenes,
                                             make_predict_fn)
from mvsdet_torch.models.mvsdet import build_model
from mvsdet_torch.tools import test as test_launcher

import _parallel_ranks as ranks
from test_torch_port_interop import narrow

REPO = Path(__file__).resolve().parents[1]
TIMING = ("predict_s_first", "predict_s_per_scene")
VIS_FILES = ("boxes_0.png", "boxes_1.png", "boxes_2.png", "render_0.png",
             "render_1.png", "gt_0.png", "gt_1.png", "render_depth_0.png",
             "render_depth_1.png", "src_depth_0.png", "src_depth_1.png",
             "src_depth_2.png", "gaussians.ply")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this module runs: the tiny networks here
    gain nothing from more, and beside the other test workers, which fill
    the machine's cores, each extra thread only waits at its barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_test_launcher():
    """The JAX package's `tools/test.py` as a module (its imports of JAX
    and of the package wait inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_test", REPO / "tools" / "test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fixed_prediction(cfg, scene, seed):
    """A host prediction of every key a diagnostics predict returns, drawn
    from ``seed``: its first boxes the scene's GT boxes moved a little and
    kept, with their labels, so the APs are not 0; PSD covariances, so the
    PLY export's eigh holds."""
    rng = np.random.default_rng(seed)
    md = cfg.model.head.max_detections
    gt = scene["gt_boxes"][scene["gt_mask"]]
    boxes = np.concatenate([rng.uniform(-1, 1, (md, 3)),
                            rng.uniform(0.2, 0.8, (md, 3))], 1)
    boxes[:len(gt)] = gt + rng.normal(0, 0.05, gt.shape)
    labels = rng.integers(0, cfg.model.head.n_classes, md).astype(np.int32)
    labels[:len(gt)] = scene["gt_labels"][scene["gt_mask"]]
    mask = rng.uniform(0, 1, md) < 0.5
    mask[:len(gt)] = True
    n, t = scene["images"].shape[0], scene["gt_images"].shape[0]
    h, w = cfg.model.feature_size
    ht, wt = cfg.model.target_size
    g = 300
    a = rng.normal(0, 0.05, (g, 3, 3))
    return dict(
        boxes=boxes.astype(np.float32),
        scores=rng.uniform(0, 1, md).astype(np.float32),
        labels=labels, mask=mask,
        rendered=rng.uniform(0, 1, (t, ht, wt, 3)).astype(np.float32),
        depth_expect=rng.uniform(0.5, 4, (n, h, w)).astype(np.float32),
        rendered_depth=rng.uniform(0, 4, (t, ht, wt)).astype(np.float32),
        weight_gap=np.float32(rng.uniform(0, 1)),
        src_rmse=np.float32(rng.uniform(0, 2)),
        gs_means=rng.uniform(-1, 1, (g, 3)).astype(np.float32),
        gs_covariances=(a @ a.transpose(0, 2, 1)
                        + 1e-4 * np.eye(3)).astype(np.float32),
        gs_harmonics=rng.normal(0, 0.3, (g, 3, 25)).astype(np.float32),
        gs_opacities=rng.uniform(0, 1, g).astype(np.float32))


@pytest.fixture(scope="module")
def fixed():
    cfg = tiny_test_config()
    scenes = [make_synthetic_scene(cfg, seed=s, n_views=4, n_targets=2)
              for s in range(3)]
    preds = [fixed_prediction(cfg, scene, s) for s, scene in enumerate(scenes)]
    return cfg, scenes, preds


def test_evaluate_scenes_matches_jax_on_fixed_predictions(fixed):
    cfg, scenes, preds = fixed
    calls = {"port": [], "jax": []}

    def run(evaluate, side):
        it = iter(preds)
        return evaluate(lambda batch: next(it), scenes,
                        num_classes=cfg.model.head.n_classes,
                        vis_hook=lambda si, scene, out: calls[side].append(
                            (si, scene["origin"].tolist(),
                             float(out["weight_gap"]))))

    got = run(evaluate_scenes, "port")
    want = run(jx_harness.evaluate_scenes, "jax")
    got = {k: v for k, v in got.items() if k not in TIMING}
    want = {k: v for k, v in want.items() if k not in TIMING}
    for key in ("depth_rmse", "weight_gap", "src_rmse", "mvs_rmse", "psnr"):
        assert key in got and np.isfinite(got[key]), key
    assert got["mAP_0.25"] > 0, "the APs' equality would hold trivially"
    assert got == want
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == [0, 1, 2]


def test_vis_hook_writes_what_jax_writes(fixed, tmp_path, capsys):
    cfg, scenes, preds = fixed
    for side, launcher in (("port", test_launcher),
                           ("jax", jax_test_launcher())):
        launcher.make_vis_hook(str(tmp_path / side), cfg)(
            1, scenes[1], preds[1])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == printed[1] and printed[0].startswith(
        "scene0001: wrote ")
    for name in VIS_FILES:
        port = (tmp_path / "port" / "scene0001" / name).read_bytes()
        assert port == (tmp_path / "jax" / "scene0001" / name).read_bytes(), \
            name
    assert sorted(p.name for p in (tmp_path / "port" / "scene0001")
                  .iterdir()) == sorted(VIS_FILES)


def ply_vertices(path) -> int:
    with open(path, "rb") as f:
        header = f.read(1024).split(b"end_header")[0].decode()
    return int(header.split("element vertex ")[1].split()[0])


def test_launcher_writes_the_diagnostics_on_the_cpu(tmp_path):
    results = test_launcher.main([
        "--tiny", "--synthetic", "2", "--device", "cpu", "--diagnostics",
        "--vis-dir", str(tmp_path)])
    for key in ("depth_rmse", "weight_gap", "src_rmse", "mvs_rmse",
                "psnr", "mAP_0.25"):
        assert np.isfinite(results[key]), key
    assert 0 <= results["weight_gap"] <= 1
    for s in range(2):
        scene = tmp_path / f"scene{s:04d}"
        for name in ("boxes_0.png", "boxes_2.png", "render_0.png",
                     "gt_0.png", "render_depth_0.png", "src_depth_2.png"):
            assert (scene / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", \
                name
        assert ply_vertices(scene / "gaussians.ply") > 0


def test_sharded_predict_with_diagnostics_matches_the_single(tmp_path):
    cfg = narrow(tiny_test_config())
    scenes = [make_synthetic_scene(cfg, seed=20 + s, n_views=4, n_targets=1)
              for s in range(2)]
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    weights = tmp_path / "weights.pt"
    torch.save(model.state_dict(), weights)
    np.savez(tmp_path / "scenes.npz", **{f"{i}/{k}": v for i, s in
                                         enumerate(scenes)
                                         for k, v in s.items()})
    handle = ranks.start(ranks.predict, 2, tmp_path / "ranks", cfg,
                         str(weights), str(tmp_path / "scenes.npz"), 2, True)
    predict = make_predict_fn(model, "cpu", diagnostics=True)
    single = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' thread count: equal sums
    try:
        one = evaluate_scenes(lambda b: single.append(predict(b)) or
                              single[-1], scenes,
                              cfg.model.head.n_classes, device="cpu")
    finally:
        torch.set_num_threads(threads)
    handle.join()
    outs = [ranks.load(tmp_path / "ranks", r) for r in range(2)]
    got = {k[len("metric/"):]: float(v) for k, v in outs[0].items()
           if k.startswith("metric/")}
    for key in ("depth_rmse", "weight_gap", "src_rmse"):
        assert key in got and np.isfinite(got[key]), key
    assert {k: v for k, v in got.items() if k not in TIMING} == \
        {k: v for k, v in one.items() if k not in TIMING}
    for s, pred in enumerate(single):
        assert {"rendered_depth", "gs_means", "weight_gap"} <= set(pred)
        for key, value in pred.items():
            np.testing.assert_array_equal(outs[0][f"pred/0/{key}"][s], value,
                                          err_msg=f"scene {s} {key}")
