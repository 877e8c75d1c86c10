"""Predict closure and metric harness (port of
mvsdet_tpu/evaluation/harness.py: `make_predict_fn` :33-50 and
`evaluate_scenes` :84-219).

`evaluate_scenes` streams its scenes: it takes any iterable of host
batches and pulls and stages scene i+1 on a thread while the card
predicts scene i, keeping of each scene only what its metrics need (the
JAX version copies every scene into a list first).  The data-parallel
`group_size` waits for the port's parallelism, and the metrics of the
JAX predict's diagnostics (`depth_rmse` of the rendered target depth,
`weight_gap`, `src_rmse`) and `vis_hook` for the port's diagnostics: the
port's predict returns none of what they read, and the JAX harness adds
their keys only when a prediction carries it.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from mvsdet_torch.data.prefetch import stage_batch
from mvsdet_torch.evaluation.indoor_eval import indoor_map
from mvsdet_torch.evaluation.nvs_metrics import depth_rmse, psnr, ssim
from mvsdet_torch.models.mvsdet import MVSDet


def make_predict_fn(model: MVSDet, device="cuda"
                    ) -> Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """fn(host numpy batch) -> host numpy prediction dict.

    The model is moved to ``device``, which is the card unless the caller
    asks for the CPU (raises when CUDA is missing).  Each batch is copied
    there (a batch already staged there is taken as it is), predicted
    under `torch.inference_mode`, and the outputs (boxes, scores, labels,
    mask, rendered, depth_expect) are copied back, which waits for the
    device.  A bf16 model's scores come back as float32, which holds every
    bf16 value exactly (numpy has no bfloat16).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    model.to(device)

    def predict(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        tensors = {k: torch.as_tensor(v).to(device, non_blocking=True)
                   for k, v in batch.items()}
        with torch.inference_mode():
            out = model.predict(tensors)
        return {k: (v.to(torch.float32) if v.dtype == torch.bfloat16
                    else v).cpu().numpy() for k, v in out.items()}

    return predict


def evaluate_scenes(predict_fn: Callable, scenes: Iterable[Dict],
                    num_classes: int, device=None) -> Dict[str, float]:
    """Run predict over host scene batches and aggregate the metrics.

    Args:
      predict_fn: fn(batch) -> host numpy prediction dict, such as
        `make_predict_fn`'s closure.
      scenes: iterable of host batch dicts (numpy, static shapes), pulled
        one scene ahead of the predict, never further.
      num_classes: detection classes for mAP.
      device: where the thread stages each batch (`data/prefetch.py`'s
        `stage_batch`) before ``predict_fn`` gets it; None hands
        ``predict_fn`` the host batch.

    Returns the JAX harness's metric dict: mAP_0.25 / mAP_0.50 (and mAR,
    per-class APs); psnr / ssim where scenes carry `gt_images` and the
    prediction `rendered`; mvs_rmse where they carry `depth` and the
    prediction `depth_expect`; predict_s_first and, past the first scene,
    predict_s_per_scene (seconds, host clock; the outputs' copy to the
    host ends each predict).
    """
    it = iter(scenes)
    sentinel = object()

    def pull():
        scene = next(it, sentinel)
        if scene is sentinel:
            return sentinel
        return scene, (scene if device is None
                       else stage_batch(scene, device))

    preds, gts = [], []
    psnrs, ssims, mvs_rmses = [], [], []
    predict_times = []
    with ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(pull)
        while True:
            item = nxt.result()
            if item is sentinel:
                break
            nxt = pool.submit(pull)
            scene, batch = item
            t0 = time.perf_counter()
            out_np = predict_fn(batch)
            predict_times.append(time.perf_counter() - t0)

            mask = out_np["mask"]
            preds.append({"boxes": out_np["boxes"][mask],
                          "scores": out_np["scores"][mask],
                          "labels": out_np["labels"][mask]})
            gmask = np.asarray(scene["gt_mask"])
            gts.append({"boxes": np.asarray(scene["gt_boxes"])[gmask],
                        "labels": np.asarray(scene["gt_labels"])[gmask]})
            if "rendered" in out_np and "gt_images" in scene:
                for t in range(out_np["rendered"].shape[0]):
                    r = out_np["rendered"][t]
                    g = np.asarray(scene["gt_images"][t])
                    psnrs.append(psnr(r, g))
                    ssims.append(ssim(r, g))
            if "depth" in scene and "depth_expect" in out_np:
                # MVSMetric: source depth expectation vs GT at feature res
                est = out_np["depth_expect"]                    # (N, h, w)
                gt = np.asarray(scene["depth"], np.float64)
                mvs_rmses.append(depth_rmse(
                    est, _resize_nearest(gt, est.shape[1:3])))

    results = indoor_map(preds, gts, num_classes=num_classes)
    if psnrs:
        results["psnr"] = float(np.mean(psnrs))
        results["ssim"] = float(np.mean(ssims))
    if mvs_rmses:
        results["mvs_rmse"] = float(np.mean(mvs_rmses))
    if predict_times:
        # the first scene pays the warm-up; steady state is the rest
        results["predict_s_first"] = predict_times[0]
        if len(predict_times) > 1:
            results["predict_s_per_scene"] = float(
                np.mean(predict_times[1:]))
    return results


def _resize_nearest(imgs: np.ndarray, hw) -> np.ndarray:
    """(N, H, W) -> (N, h, w) nearest-neighbour (depth maps: no blending
    across the invalid-0 boundary)."""
    n, h0, w0 = imgs.shape
    h, w = hw
    ys = (np.arange(h) * h0 / h).astype(np.int64)
    xs = (np.arange(w) * w0 / w).astype(np.int64)
    return imgs[:, ys[:, None], xs[None, :]]
