"""Predicts through the port's `evaluate_scenes` over `make_predict_fn`,
as the test launcher runs them: one scene of the pool at a time, the next
one staged on a thread, each predict timed by a wrapper from the call to
the outputs on the host, the host metrics after each.

The check compares a sample of the window's predicts, drawn from the
seed, with the reference's predict of the same scenes.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark import check, flops, runs, scenes
from benchmark.trace import KernelInputs, NmsSpans, traced
from benchmark.weights import draw_weights, traffic_weights


def plant(model, fault: Optional[str]) -> List[Callable[[], None]]:
    """Plant one of the check's faults under the timed path; returns what
    undoes it."""
    undo = []
    if fault == "half_batch":
        # the lift's mean over the views taken over half of them
        from mvsdet_torch.models import mvsdet as port_mvsdet
        lift = port_mvsdet.lift_features_to_voxels

        def half_lift(feats, proj, depth, prob, points, vz):
            n = feats.shape[0] // 2
            return lift(feats[:n], proj[:n], depth[:n], prob[:n], points, vz)
        port_mvsdet.lift_features_to_voxels = half_lift
        undo.append(lambda: setattr(port_mvsdet, "lift_features_to_voxels",
                                    lift))
    elif fault == "altered":
        whole = model.predict

        def altered(batch, **kw):
            out = whole(batch, **kw)
            out["boxes"] = out["boxes"].clone()
            out["boxes"][:, 0] += 0.05          # the answer's boxes 5 cm off
            return out
        model.predict = altered
    return undo


def p90(latencies_s: List[float]) -> float:
    lat = sorted(latencies_s)
    return (statistics.quantiles(lat, n=10, method="inclusive")[-1]
            if len(lat) > 1 else lat[0])


def run(cell, cfg, values, seed: int, seconds: float, trace: bool, device,
        mark_window: Callable[[], None],
        fault: Optional[str] = None) -> runs.Run:
    """The warm-up, the window, then with ``trace`` a traced stretch of
    `trace_items` predicts; the check after."""
    from mvsdet_torch.evaluation.harness import (evaluate_scenes,
                                                 make_predict_fn)
    from mvsdet_torch.models.mvsdet import MVSDet

    traffic = cell.traffic
    run = runs.Run()
    n_views, n_targets = runs.views(cfg, traffic)
    pool = scenes.make_pool(cfg, seed, traffic["pool"], n_views, n_targets,
                            cfg.model.head.with_yaw, device)
    with torch.device(device):
        model = MVSDet(cfg.model)
    draw_weights(model, seed, **traffic_weights(traffic))
    model.eval()
    undo = plant(model, fault)
    predict_fn = make_predict_fn(model, device)
    n_classes = cfg.model.head.n_classes
    record: List = []

    def timed(batch):
        t = time.perf_counter()
        out = predict_fn(batch)
        record.append((time.perf_counter() - t, out))
        return out

    evaluate_scenes(timed, pool[:traffic["warmup"]], n_classes,
                    device=device)
    record.clear()
    t_end = [0.0]
    order: List[int] = []

    def feed():
        i = 0
        while time.perf_counter() < t_end[0]:
            order.append(i % len(pool))
            yield pool[i % len(pool)]
            i += 1

    runs.reset_peak(device)
    mark_window()
    t0 = time.perf_counter()
    t_end[0] = t0 + seconds
    evaluate_scenes(timed, feed(), n_classes, device=device)
    run.window_s = time.perf_counter() - t0
    run.items = len(record)
    run.latencies_s = [t for t, _ in record]
    run.failed = sum(not all(np.isfinite(out[k]).all()
                             for k in ("boxes", "scores", "rendered",
                                       "depth_expect"))
                     for _, out in record)
    run.window_peak_bytes = runs.peak(device)
    run.end_to_end["predict_scenes_per_s"] = (run.items / run.window_s,
                                              "scenes/s")
    run.end_to_end["predict_p90_ms"] = (1e3 * p90(run.latencies_s), "ms")
    runs.log("window closed", predicts=run.items,
             seconds=round(run.window_s, 3))

    if trace:
        kernels, nms = KernelInputs(), NmsSpans()
        items = traffic["trace_items"]
        # the NMS's spans away from the profiler, whose per-launch cost
        # would stretch the launch-bound greedy picks
        with nms.installed():
            evaluate_scenes(predict_fn, pool[:items], n_classes,
                            device=device)
        with kernels.installed():
            run.ctx["trace"] = traced(lambda: evaluate_scenes(
                predict_fn, pool[:items], n_classes, device=device))
        run.ctx["items_traced"] = items
        run.ctx["kernel_bounds_ms"] = kernels.bounds_ms()
        run.ctx["nms_ms"] = nms.spans_ms()
        run.ctx["flops_per_item"] = flops.scene_flops(
            check.reference_config(values), n_views, n_targets,
            False)["total"]
        del kernels, nms
    run.peak_bytes = runs.peak(device)
    for u in undo:
        u()
    del model, predict_fn
    runs.free(device)

    order = order[:len(record)]
    calls = check.sample_calls(seed, order, traffic["check_sample"])
    prog = [record[i][1] for i in calls]
    t = time.perf_counter()
    ref = check.reference_predict(values, seed, traffic_weights(traffic),
                                  [pool[order[i]] for i in calls], device)
    head = cfg.model.head
    min_kept = traffic["check_min_kept"]
    run.numbers = check.judge_predict(prog, ref, head, min_kept, device)
    run.detail = check.predict_detail(prog, ref, head, min_kept, device)
    runs.log("reference done", seconds=round(time.perf_counter() - t, 3),
             calls=calls, kept=run.detail["kept"],
             candidates=run.detail["candidates"])
    return run


def control(cell, seed: int, device="cuda") -> dict:
    """The control's numbers at one seed: the reference's predicts with
    TF32 on against the same predicts with TF32 off, on the sample of
    the pool's scenes the seed draws."""
    values = cell.config["config"]
    traffic = cell.traffic
    cfg = check.reference_config(values)
    n_views, n_targets = runs.views(cfg, traffic)
    pool = scenes.make_pool(cfg, seed, traffic["pool"], n_views, n_targets,
                            cfg.model.head.with_yaw, device)
    calls = check.sample_calls(seed, list(range(len(pool))),
                               traffic["check_sample"])
    batches = [pool[i] for i in calls]
    weights = traffic_weights(traffic)
    got = check.reference_predict(values, seed, weights, batches, device,
                                  use_tf32=True)
    want = check.reference_predict(values, seed, weights, batches, device)
    head, min_kept = cfg.model.head, traffic["check_min_kept"]
    return dict(numbers=check.judge_predict(got, want, head, min_kept,
                                            device),
                detail=check.predict_detail(got, want, head, min_kept,
                                            device))
