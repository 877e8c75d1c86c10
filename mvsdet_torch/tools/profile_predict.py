"""Where one predict's time goes on the card.

    python -m mvsdet_torch.tools.profile_predict [--dtype bfloat16]
                                                 [--config arkit]

Builds `scannet_config()` (or `arkit_config()`) at full width with seeded
random weights, runs a synthetic scene of the preset's test views (80
source views and one target; ARKit: 100 and one, with per-view
intrinsics) through `make_predict_fn` three times to warm up, times one
more with the NMS between two CUDA events (its span on the device and
its share of that predict's host latency: the rotated NMS for ARKit),
then traces one more predict with `torch.profiler` and prints JSON lines:
the card (as nvidia-smi names it, with its power limit), the traced
predict's host latency, the device's busy time (the union of its kernel
intervals) and idle share over that latency, its device-to-host copies
(each a host read that waits for the device), and the kernels that took
the most device time, summed by name.  TF32 is off, as in the JAX
predict path.  `--dtype bfloat16` profiles the model computing in bf16
(its parameters stay float32).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mvsdet_torch.config import Config, arkit_config, scannet_config
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.models import head
from mvsdet_torch.models.mvsdet import build_model


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


TOP = 20
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIGS = {"scannet": scannet_config, "arkit": arkit_config}


def command_parser(description: str) -> argparse.ArgumentParser:
    """The profilers' `--dtype` and `--config` options."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                        help="the model's compute dtype")
    parser.add_argument("--config", choices=sorted(CONFIGS),
                        default="scannet", help="the model's preset")
    return parser


def command_line(description: str):
    """(config, its name, compute dtype) from the command line's
    `--config` and `--dtype`."""
    args = command_parser(description).parse_args()
    return CONFIGS[args.config](), args.config, DTYPES[args.dtype]


def synthetic_scene(cfg: Config, name: str, train: bool):
    """A synthetic scene of the preset's training or test views, with
    per-view intrinsics and yaw boxes for ARKit."""
    data = cfg.data
    return make_synthetic_scene(
        cfg, seed=0, n_views=data.n_src_train if train else data.n_src_test,
        n_targets=(data.nerf_target_views_train if train
                   else data.nerf_target_views_test), arkit=name == "arkit")


def main() -> None:
    cfg, name, dtype = command_line(__doc__.split("\n")[0])
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict measures the card; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    predict = make_predict_fn(build_model(
        cfg, generator=torch.Generator().manual_seed(cfg.seed), dtype=dtype))
    scene = synthetic_scene(cfg, name, train=False)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict(scene)
        warm.append((time.perf_counter() - t0) * 1e3)

    # the NMS's span on the device, between two events recorded in the
    # stream around it (the host copy at the end of predict waits for both)
    nms_name = "rotated_3d_nms" if cfg.model.head.with_yaw \
        else "aligned_3d_nms"
    nms = getattr(head, nms_name)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_nms(*args):
        events[0].record()
        out = nms(*args)
        events[1].record()
        return out

    setattr(head, nms_name, timed_nms)
    try:
        t0 = time.perf_counter()
        predict(scene)
        nms_latency_ms = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(head, nms_name, nms)
    nms_ms = events[0].elapsed_time(events[1])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(scene)
        latency_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    kernel_ms = sum(ms for ms, _ in by_name.values())
    host_reads = sum(n for name, (_, n) in by_name.items()
                     if name.startswith("Memcpy DtoH"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({
        "config": name, "views": cfg.data.n_src_test, "dtype": str(dtype),
        "warmup_latency_ms": warm, "nms": nms_name, "nms_ms": nms_ms,
        "nms_share": nms_ms / nms_latency_ms,
        "nms_predict_latency_ms": nms_latency_ms,
        "latency_ms": latency_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / latency_ms,
        "kernel_ms": kernel_ms, "device_events": len(kernels),
        "device_to_host_copies": host_reads,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
        flush=True)
    for name, (ms, n) in top:
        print(json.dumps({"kernel": name[:120], "ms": ms, "launches": n,
                          "share": ms / kernel_ms}), flush=True)


if __name__ == "__main__":
    main()
