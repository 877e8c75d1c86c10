"""Where a cell's time goes, by the program's spans.

    python -m benchmark.span_report --workload <cell> --seed <n>
                                    [--items 3] [--cost-items 8]

Builds the cell's program from the seed as its mode does (the pool of
scenes, the weights), warms it up, then runs ``--items`` steps or
predicts under `torch.profiler` (every thread) inside the port's
`recording()`, and prints one JSON line:

- `per_item`: each span's device ms, kernel launches and host syncs a
  step or predict, every kernel and runtime call given its innermost
  span by `benchmark.spans.attribute`; `no_span_share`, the share of
  device time under no span;
- `host_ms`: the recorder's host ms a step or predict of each span;
- `pairing`: how the readers' pairing of kernels with their launches
  by order agrees with the profiler's correlation ids;
- `readers`: the per-layer readers of `benchmark/metrics/` on the same
  trace in the flat form a traced run hands them, with `sweep_ms_paired`,
  the attribution's own sweep time, beside them; `calls`, the host's
  runtime and driver calls by name, `launch_calls` and `kernels`;
- `cost`: ms an item with the recorder off and on, in alternating blocks
  of ``--cost-items``, and the relative cost.

It runs on the card only; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
import time
from collections import Counter

import torch

from benchmark import cells, harness, runs, scenes, spans
from benchmark.weights import draw_weights, traffic_weights


def _program(cell, cfg, seed: int, device: str):
    """fn(n): run the next n steps or predicts of the cell's program."""
    traffic = cell.traffic
    n_views, n_targets = runs.views(cfg, traffic)
    pool = scenes.make_pool(cfg, seed, traffic["pool"], n_views, n_targets,
                            cfg.model.head.with_yaw, device)
    feed = itertools.cycle(pool)
    if traffic["mode"] == "train":
        from mvsdet_torch.training import loop
        state = cells.load_mode(cell).build_train(
            cfg, seed, traffic_weights(traffic), device)
        return lambda n: loop.fit(state, itertools.islice(feed, n), n)
    from mvsdet_torch.evaluation.harness import (evaluate_scenes,
                                                 make_predict_fn)
    from mvsdet_torch.models.mvsdet import MVSDet
    with torch.device(device):
        model = MVSDet(cfg.model)
    draw_weights(model, seed, **traffic_weights(traffic))
    predict_fn = make_predict_fn(model.eval(), device)
    return lambda n: evaluate_scenes(predict_fn, itertools.islice(feed, n),
                                     cfg.model.head.n_classes, device=device)


def _profile():
    """A profiler of the host's every thread (the staging one too) and the
    card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _pairing(attributed) -> dict:
    """How the readers' pairing of kernels with launches by order agrees
    with the profiler's correlation ids: pairs checked, pairs whose ids
    differ, and the least lead of a kernel's start over its launch's."""
    from torch.autograd import DeviceType
    launches = sorted((u for u, _ in attributed
                       if spans.call_kind(u.name, spans.LAUNCHES)),
                      key=lambda u: u.time_range.start)
    kernels = sorted((u for u, _ in attributed
                      if u.device_type != DeviceType.CPU
                      and not u.name.startswith(("Memcpy", "Memset"))),
                     key=lambda u: u.time_range.start)
    pairs = list(zip(launches, kernels))
    return dict(launches=len(launches), kernels=len(kernels),
                wrong=sum(1 for c, k in pairs if c.id != k.id),
                least_lead_us=min((k.time_range.start - c.time_range.start
                                   for c, k in pairs), default=None))


def report(cell_name: str, seed: int, items: int, cost_items: int,
           device: str = "cuda") -> dict:
    from mvsdet_torch import config as port_config
    from mvsdet_torch.utils import profiling
    cell = cells.find_cell(cell_name)
    cfg = cells.build_config(port_config, cell.config["config"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = cell.traffic["mode"]
    run = _program(cell, cfg, seed, device)
    run(2)
    runs.sync(device)

    with profiling.recording() as recorded, _profile() as prof:
        t0 = time.perf_counter()
        run(items)
        runs.sync(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    attributed = spans.attribute(events)
    out = spans.summary(attributed, wall * 1e6, items)
    out["pairing"] = _pairing(attributed)
    host_ms = {}
    for s in recorded:
        host_ms[s.name] = host_ms.get(s.name, 0.0) + s.seconds * 1e3 / items
    out["host_ms"] = host_ms

    from torch.autograd import DeviceType
    flat = dict(wall_s=wall, kernels=[], host=[])
    for e in events:
        key = "kernels" if e.device_type == DeviceType.CUDA else "host"
        flat[key].append((e.name, e.time_range.start, e.time_range.end))
    ctx = dict(mode=mode, trace=flat, items_traced=items)
    out["readers"] = {m["name"]: harness.reader(m["name"])(ctx)
                      for m in cell.per_layer}
    out["readers"]["sweep_ms_paired"] = out["per_item"].get(
        "mvsdet.sweep", {}).get("ms")
    calls = Counter(n for n, _, _ in flat["host"] if n.startswith("cu"))
    out["calls"] = dict(calls.most_common())
    out["launch_calls"] = sum(v for n, v in calls.items()
                              if spans.call_kind(n, spans.LAUNCHES))
    out["kernels"] = sum(1 for n, _, _ in flat["kernels"]
                         if not n.startswith(("Memcpy", "Memset")))
    del prof, events, flat, ctx

    off, on = [], []
    for _ in range(3):
        for times, rec in ((off, False), (on, True)):
            runs.sync(device)
            t0 = time.perf_counter()
            if rec:
                with profiling.recording():
                    run(cost_items)
            else:
                run(cost_items)
            runs.sync(device)
            times.append((time.perf_counter() - t0) * 1e3 / cost_items)
    out["cost"] = dict(off_ms=off, on_ms=on, relative=statistics.median(on)
                       / statistics.median(off) - 1.0)
    out.update(workload=cell_name, seed=seed, items=items,
               card=harness.power_limit())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--items", type=int, default=3)
    parser.add_argument("--cost-items", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_report: runs on the card; no CUDA device",
              file=sys.stderr)
        return 3
    print(json.dumps(report(args.workload, args.seed, args.items,
                            args.cost_items)), flush=True)
    return 0


if __name__ == "__main__":
    harness.set_caches()
    sys.exit(main())
