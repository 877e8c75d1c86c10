"""One run of one cell: set up, measure, read, check, print one line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The run fails, printing no result, where it finds fewer CUDA cards than
the cell asks for, and where a module whose top-level name is `jax`,
`jaxlib`, `flax`, `optax` or `mvsdet_tpu` has been imported by the time
the window closes.  Its last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `check`: each number compared with its limit); the
last lines of standard error are the same numbers and limits.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

# every build and kernel cache of the program at a fixed path inside the
# checkout (the port builds its kernels into build/kernels/ itself)
ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvsdet_tpu")
PACKAGE = Path(__file__).resolve().parent.name


def set_caches() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str, root: Path = ROOT):
    """The `read` function of `benchmark/metrics/<name>.py`."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", root / PACKAGE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", values: Optional[dict] = None,
        fault: Optional[str] = None, traffic: Optional[dict] = None) -> Dict:
    """One run of the cell; returns the result line's object.  ``values``
    replaces the configuration's sizes and ``traffic`` updates the
    traffic's entries (the CPU tests' small ones); ``fault`` plants one of
    the mode's faults (the check's tests)."""
    import torch

    from benchmark import cells, check
    from mvsdet_torch import config as port_config

    cell = cells.find_cell(cell_name)
    if traffic:
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                      **traffic))
    values = cell.config["config"] if values is None else values
    cfg = cells.build_config(port_config, values)
    if cell.config.get("tf32", False) is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    marks = {}
    result = cells.load_mode(cell).run(
        cell, cfg, values, seed, seconds, trace, device,
        mark_window=lambda: marks.setdefault("window", time.perf_counter()),
        fault=fault)
    e2e = dict(result.end_to_end, setup_s=(marks["window"] - t_start, "s"))

    line: Dict = {"correct": False, "attempted": result.items,
                  "failed": result.failed}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": result.peak_bytes}
    if trace:
        from benchmark.trace import breakdown, busy_us
        ctx = dict(result.ctx, mode=cell.traffic["mode"],
                   window_s=result.window_s, items=result.items,
                   window_peak_bytes=result.window_peak_bytes)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = ctx["trace"]
        dev["busy_s"] = busy_us([(s, e) for _, s, e in t["kernels"]]) / 1e6
        dev["window_s"] = t["wall_s"]
        line["breakdown"] = breakdown(t)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": m["unit"]} for m in cell.end_to_end}
    line["metrics"] = metrics
    line["device"] = dev
    line["correct"] = check.verdict(result.numbers, cell.limits) \
        and result.failed == 0
    # JSON has no infinity or NaN: a number that could not be read at all
    # (a shape that differs, a loss that is not finite) is 1e30
    line["check"] = {k: {"value": (result.numbers[k]
                                   if math.isfinite(result.numbers[k])
                                   else 1e30),
                         "limit": cell.limits[k]} for k in cell.limits}
    return line


def main(t_start: float, argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import cells
    try:
        cell = cells.find_cell(args.workload)
    except (KeyError, OSError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}, so nothing is measured",
              file=sys.stderr)
        return 3
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run imported {', '.join(loaded)}; the port "
              f"must run without JAX or the JAX package", file=sys.stderr)
        return 4
    limit = power_limit()
    if limit:
        line["device"]["card"] = limit
        print(f"card: {limit}", file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
