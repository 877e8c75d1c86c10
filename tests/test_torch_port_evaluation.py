"""The port's metrics and metric harness against the JAX package's.

`indoor_map` (aligned and rotated boxes), `psnr`, `ssim` and `depth_rmse`
on seeded random inputs, to 1e-12; `evaluate_scenes` with one fixed stub
prediction per scene against JAX's `evaluate_scenes` (the timing keys by
presence); and the streaming: a generator of scenes is pulled at most one
scene ahead of the predict.
"""

import numpy as np
import pytest
import torch

from mvsdet_tpu.evaluation import harness as jx_harness
from mvsdet_tpu.evaluation import indoor_eval as jx_indoor
from mvsdet_tpu.evaluation import nvs_metrics as jx_nvs

from mvsdet_torch.evaluation import indoor_eval, nvs_metrics
from mvsdet_torch.evaluation.harness import evaluate_scenes

TIMING = ("predict_s_first", "predict_s_per_scene")


def assert_same_metrics(got, want, atol=1e-12):
    assert set(got) == set(want)
    for key in want:
        if key not in TIMING:
            assert abs(got[key] - want[key]) <= atol, (key, got[key],
                                                       want[key])


def random_boxes(rng, n, rotated):
    centre = rng.uniform(-2, 2, (n, 3))
    size = rng.uniform(0.3, 1.5, (n, 3))
    parts = [centre, size] + ([rng.uniform(-np.pi, np.pi, (n, 1))]
                              if rotated else [])
    return np.concatenate(parts, 1).astype(np.float32)


def random_scenes(rotated, seed, n_scenes=4, n_classes=6):
    """Per scene: GT boxes and predictions near them, plus far ones.  Scene
    1 has no predictions, class 5 is never predicted, and scores repeat
    (ties), so each of those paths is taken."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for s in range(n_scenes):
        n_gt = rng.randint(2, 6)
        gt = random_boxes(rng, n_gt, rotated)
        gt_labels = rng.randint(0, n_classes, n_gt)
        gt_labels[0] = 5
        near = gt + rng.normal(0, 0.15, gt.shape).astype(np.float32)
        far = random_boxes(rng, 6, rotated)
        boxes = np.concatenate([near, far])
        labels = np.concatenate([gt_labels, rng.randint(0, 5, 6)])
        labels[labels == 5] = 4
        scores = rng.choice([0.2, 0.5, 0.7, 0.9], len(boxes)) \
            .astype(np.float32)
        if s == 1:
            boxes, labels, scores = boxes[:0], labels[:0], scores[:0]
        preds.append(dict(boxes=boxes, scores=scores, labels=labels))
        gts.append(dict(boxes=gt, labels=gt_labels))
    return preds, gts


@pytest.mark.parametrize("rotated", [False, True], ids=["aligned", "yaw"])
@pytest.mark.parametrize("seed", [0, 1])
def test_indoor_map_matches_jax(rotated, seed):
    preds, gts = random_scenes(rotated, seed)
    got = indoor_eval.indoor_map(preds, gts, num_classes=6)
    want = jx_indoor.indoor_map(preds, gts, num_classes=6)
    assert_same_metrics(got, want)
    assert 0 < want["mAP_0.25"] < 1
    assert "AP_5_0.25" in want and want["AP_5_0.25"] == 0


def test_box_ious_match_jax():
    rng = np.random.RandomState(3)
    for rotated in (False, True):
        a, b = random_boxes(rng, 9, rotated), random_boxes(rng, 7, rotated)
        got = indoor_eval.box_iou(a, b)
        np.testing.assert_array_equal(got, jx_indoor.box_iou(a, b))
        assert (got > 0).any()


def test_nvs_metrics_match_jax():
    rng = np.random.RandomState(4)
    gt = rng.rand(24, 32, 3)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)
    for name in ("psnr", "ssim"):
        got = getattr(nvs_metrics, name)(pred, gt)
        want = getattr(jx_nvs, name)(pred, gt)
        assert abs(got - want) <= 1e-12 * abs(want), name
    depth = rng.uniform(0.5, 4, (2, 12, 16))
    depth[:, :3] = 0                            # invalid pixels
    est = depth + rng.normal(0, 0.2, depth.shape)
    got, want = nvs_metrics.depth_rmse(est, depth), jx_nvs.depth_rmse(est,
                                                                      depth)
    assert got == pytest.approx(want, rel=1e-12) and want > 0


def harness_case(n_scenes=3, seed=5):
    """Host scenes (GT boxes under a mask, target images, source depth) and
    one fixed prediction per scene (kept boxes under a mask, rendered
    views, depth expectation at a quarter of the depth's size)."""
    rng = np.random.RandomState(seed)
    preds, gts = random_scenes(False, seed, n_scenes)
    scenes, outs = [], []
    for p, g in zip(preds, gts):
        gt_boxes = np.zeros((8, 6), np.float32)
        gt_labels = np.zeros(8, np.int32)
        gt_mask = np.zeros(8, bool)
        n = len(g["boxes"])
        gt_boxes[:n], gt_labels[:n], gt_mask[:n] = g["boxes"], g["labels"], 1
        gt_images = rng.rand(2, 16, 24, 3).astype(np.float32)
        depth = rng.uniform(0.5, 4, (3, 32, 48)).astype(np.float32)
        scenes.append(dict(gt_boxes=gt_boxes, gt_labels=gt_labels,
                           gt_mask=gt_mask, gt_images=gt_images, depth=depth))
        m = len(p["boxes"])
        boxes = np.zeros((12, 6), np.float32)
        scores = np.zeros(12, np.float32)
        labels = np.zeros(12, np.int32)
        mask = np.zeros(12, bool)
        boxes[:m], scores[:m], labels[:m], mask[:m] = (p["boxes"], p["scores"],
                                                       p["labels"], True)
        outs.append(dict(
            boxes=boxes, scores=scores, labels=labels, mask=mask,
            rendered=np.clip(gt_images + rng.normal(0, 0.1, gt_images.shape),
                             0, 1).astype(np.float32),
            depth_expect=rng.uniform(0.5, 4, (3, 8, 12)).astype(np.float32)))
    return scenes, outs


def stub(outs):
    calls = []

    def predict(batch):
        calls.append(batch)
        return outs[len(calls) - 1]

    return predict, calls


def test_evaluate_scenes_matches_jax():
    scenes, outs = harness_case()
    want = jx_harness.evaluate_scenes(stub(outs)[0], scenes, num_classes=6)
    got = evaluate_scenes(stub(outs)[0], scenes, num_classes=6)
    assert_same_metrics(got, want)
    assert {"psnr", "ssim", "mvs_rmse", "mAP_0.25", "mAP_0.50"} <= set(got)
    assert got["mAP_0.25"] > 0


def test_evaluate_scenes_streams_one_scene_ahead():
    scenes, outs = harness_case(n_scenes=4)
    pulled = []

    def source():
        for scene in scenes:
            pulled.append(len(pulled))
            yield scene

    ahead = []

    def predict(batch):
        ahead.append(len(pulled) - len(ahead) - 1)
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        return outs[len(ahead) - 1]

    got = evaluate_scenes(predict, source(), num_classes=6, device="cpu")
    # while scene i is predicted at most scene i+1 has been pulled
    assert len(ahead) == 4 and max(ahead) <= 1
    assert_same_metrics(got, evaluate_scenes(stub(outs)[0], scenes, 6))
