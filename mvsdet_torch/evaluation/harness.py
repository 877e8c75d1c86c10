"""Predict closures and metric harness (port of
mvsdet_tpu/evaluation/harness.py: `make_predict_fn` :33-50,
`make_sharded_predict_fn` :53-81 and `evaluate_scenes` :84-219).

`evaluate_scenes` streams its scenes: it takes any iterable of host
batches and pulls and stages scene i+1 (or group i+1) on a thread while
the card predicts scene i, keeping of each scene only what its metrics
need (the JAX version copies every scene into a list first).  With
`group_size` the ranks of a data group predict one scene each (the
reference's `tools/dist_test.sh`).  With ``diagnostics`` the predict
closures also return the rendered target depth, the flat Gaussians and
the lift's `weight_gap` and `src_rmse` (`MVSDet.predict`), and
`evaluate_scenes` adds `depth_rmse` (rendered target depth against
`gt_depth`) and the means of `weight_gap` and `src_rmse` to its metrics;
its ``vis_hook`` sees each scene's host prediction in order
(`tools/test.py --vis-dir`).
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mvsdet_torch.data.prefetch import stage_batch
from mvsdet_torch.evaluation.indoor_eval import indoor_map
from mvsdet_torch.evaluation.nvs_metrics import depth_rmse, psnr, ssim
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.parallel.mesh import Mesh
from mvsdet_torch.utils import profiling


def make_predict_fn(model: MVSDet, device="cuda", diagnostics: bool = False
                    ) -> Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """fn(host numpy batch) -> host numpy prediction dict, for `MVSDet` or
    `NerfDetLegacy` (whose prediction has no rendered view and no depth).
    ``diagnostics`` asks `MVSDet.predict` for its diagnostics too.

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
        return {k: v.cpu().numpy() for k, v in _predict_tensors(
            model, batch, device, diagnostics).items()}

    return predict


def _predict_tensors(model: MVSDet, batch: Dict, device,
                     diagnostics: bool = False) -> Dict[str, torch.Tensor]:
    """The model's prediction of one batch as device tensors, bf16 scores
    widened to float32."""
    tensors = {k: torch.as_tensor(v).to(device, non_blocking=True)
               for k, v in batch.items()}
    with torch.inference_mode():
        # NerfDetLegacy.predict has no diagnostics to ask for
        out = (model.predict(tensors, diagnostics=True) if diagnostics
               else model.predict(tensors))
    return {k: v.to(torch.float32) if v.dtype == torch.bfloat16 else v
            for k, v in out.items()}


def make_sharded_predict_fn(model: MVSDet, mesh: Mesh, device="cuda",
                            diagnostics: bool = False
                            ) -> Callable[[List[Dict]], Dict[str, np.ndarray]]:
    """fn(group) -> the group's host predictions, stacked on a leading
    axis, for a group of ``mesh.data`` scenes (the data-parallel predict
    of mvsdet_tpu/evaluation/harness.py:53-81, the reference's 2-GPU
    `tools/dist_test.sh`).

    Rank d of the data group predicts scene ``group[d]`` (taken as it is
    where it is staged on ``device`` already), as `make_predict_fn`
    would (with its ``diagnostics``); its fixed-shape outputs (boxes,
    scores, labels, mask, rendered, depth_expect, and the diagnostics)
    go as one float32 buffer through an all-gather over the
    data group, so every rank returns the whole group's.  The function's
    ``data_index`` tells `evaluate_scenes` which scene of a group to
    stage.  Every rank of the group must call it on every group.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    model.to(device)
    group = mesh.data_group

    def predict(scenes: List[Dict]) -> Dict[str, np.ndarray]:
        if len(scenes) != mesh.data:
            raise ValueError(f"a group of {mesh.data} scenes, not "
                             f"{len(scenes)}")
        out = _predict_tensors(model, scenes[mesh.data_index], device,
                               diagnostics)
        keys = sorted(out)
        flat = torch.cat([out[k].to(torch.float32).reshape(-1)
                          for k in keys])
        parts = [torch.empty_like(flat) for _ in range(mesh.data)]
        dist.all_gather(parts, flat, group=group)
        stacked = torch.stack(parts).cpu()
        result, offset = {}, 0
        for k in keys:
            size = out[k].numel()
            result[k] = stacked[:, offset:offset + size].reshape(
                (mesh.data,) + tuple(out[k].shape)).to(out[k].dtype).numpy()
            offset += size
        return result

    predict.data_index = mesh.data_index
    return predict


def evaluate_scenes(predict_fn: Callable, scenes: Iterable[Dict],
                    num_classes: int, device=None,
                    group_size: int = 1,
                    vis_hook: Optional[Callable[[int, Dict, Dict], None]]
                    = None) -> Dict[str, float]:
    """Run predict over host scene batches and aggregate the metrics.

    Args:
      predict_fn: fn(batch) -> host numpy prediction dict, such as
        `make_predict_fn`'s closure; with ``group_size > 1``, fn(list of
        ``group_size`` batches) -> the group's predictions stacked on a
        leading axis, such as `make_sharded_predict_fn`'s.
      scenes: iterable of host batch dicts (numpy, static shapes), pulled
        one scene (or group) ahead of the predict, never further.
      num_classes: detection classes for mAP.
      device: where the thread stages each batch (`data/prefetch.py`'s
        `stage_batch`) before ``predict_fn`` gets it; None hands
        ``predict_fn`` the host batch.  In a group, only the batch at
        ``predict_fn.data_index`` is staged, where it has one.
      group_size: scenes predicted per call (the data-parallel width).
        The final group is padded by repeating its last scene and the
        padding's outputs dropped (mvsdet_tpu harness.py:117-118), so the
        metrics equal ``group_size=1``'s.
      vis_hook: fn(scene_index, host scene, host prediction), called for
        each scene in order after its prediction reaches the host
        (`tools/test.py --vis-dir`).

    Returns the JAX harness's metric dict: mAP_0.25 / mAP_0.50 (and mAR,
    per-class APs); psnr / ssim where scenes carry `gt_images` and the
    prediction `rendered`; depth_rmse where they carry `gt_depth` and the
    prediction `rendered_depth`; mvs_rmse where they carry `depth` and the
    prediction `depth_expect`; weight_gap / src_rmse (their means) where
    the predictions carry them; predict_s_first and, past the first scene,
    predict_s_per_scene (seconds, host clock; the outputs' copy to the
    host ends each predict; in a group, the group's time over its
    scenes, and the first group's scenes all count as first).
    """
    it = iter(scenes)
    sentinel = object()
    own = getattr(predict_fn, "data_index", None)

    def pull():
        group = list(itertools.islice(it, group_size))
        if not group:
            return sentinel
        staged = [scene if device is None or own not in (None, j)
                  else stage_batch(scene, device)
                  for j, scene in enumerate(group)]
        return group, staged

    def predictions():
        """(host scene, its prediction) in order, one group ahead."""
        profiling.item(0)
        with ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(pull)
            while True:
                profiling.item(len(predict_times))
                with profiling.span("evaluate.data_wait"):
                    item = nxt.result()
                if item is sentinel:
                    return
                nxt = pool.submit(pull)
                group, staged = item
                real = len(group)
                t0 = time.perf_counter()
                with profiling.span("evaluate.predict"):
                    if group_size == 1:
                        outs = [predict_fn(staged[0])]
                    else:
                        pad = group_size - real
                        stacked = predict_fn(staged + staged[-1:] * pad)
                        outs = [{k: v[j] for k, v in stacked.items()}
                                for j in range(real)]
                dt = (time.perf_counter() - t0) / real
                for scene, out_np in zip(group, outs):
                    predict_times.append(dt)
                    yield scene, out_np

    preds, gts = [], []
    psnrs, ssims, d_rmses, mvs_rmses, wgaps, srmses = [], [], [], [], [], []
    predict_times = []
    for si, (scene, out_np) in enumerate(predictions()):
        with profiling.span("evaluate.host_metrics"):
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
            if "rendered_depth" in out_np and "gt_depth" in scene:
                for t in range(out_np["rendered_depth"].shape[0]):
                    d_rmses.append(depth_rmse(
                        out_np["rendered_depth"][t],
                        np.asarray(scene["gt_depth"][t])))
            if "depth" in scene and "depth_expect" in out_np:
                # MVSMetric: source depth expectation vs GT at feature res
                est = out_np["depth_expect"]                    # (N, h, w)
                gt = np.asarray(scene["depth"], np.float64)
                mvs_rmses.append(depth_rmse(
                    est, _resize_nearest(gt, est.shape[1:3])))
            if "weight_gap" in out_np:
                wgaps.append(float(out_np["weight_gap"]))
                srmses.append(float(out_np["src_rmse"]))
            if vis_hook is not None:
                vis_hook(si, scene, out_np)

    results = indoor_map(preds, gts, num_classes=num_classes)
    if psnrs:
        results["psnr"] = float(np.mean(psnrs))
        results["ssim"] = float(np.mean(ssims))
    if d_rmses:
        results["depth_rmse"] = float(np.mean(d_rmses))
    if mvs_rmses:
        results["mvs_rmse"] = float(np.mean(mvs_rmses))
    if wgaps:
        results["weight_gap"] = float(np.mean(wgaps))
        results["src_rmse"] = float(np.mean(srmses))
    if predict_times:
        # the first group pays the warm-up; steady state is the rest
        results["predict_s_first"] = predict_times[0]
        if len(predict_times) > group_size:
            results["predict_s_per_scene"] = float(
                np.mean(predict_times[group_size:]))
    return results


def _resize_nearest(imgs: np.ndarray, hw) -> np.ndarray:
    """(N, H, W) -> (N, h, w) nearest-neighbour (depth maps: no blending
    across the invalid-0 boundary)."""
    n, h0, w0 = imgs.shape
    h, w = hw
    ys = (np.arange(h) * h0 / h).astype(np.int64)
    xs = (np.arange(w) * w0 / w).astype(np.int64)
    return imgs[:, ys[:, None], xs[None, :]]
