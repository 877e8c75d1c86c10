"""Where one training step's time goes on the card.

    python -m mvsdet_torch.tools.profile_train [--dtype bfloat16]
                                               [--config arkit]

Builds `scannet_config()` (or `arkit_config()`, with per-view intrinsics
and the yaw head) at full width with seeded random weights and a
synthetic scene of 40 source views (240x320) and 2 render targets
(120x160), runs three `train_step`s to warm up (each timed on the host
clock, ending in a copy of the loss to host), then traces one more step
with `torch.profiler` and prints JSON lines: the card (as nvidia-smi names
it, with its power limit), the traced step's host latency, the device's
busy time (the union of its kernel intervals) and idle share over that
latency, its device-to-host copies, the peak memory, the time of the
port's five kernels and the lift backward's index (K1's and K2's also by
pass), and the kernels that took the most device time, summed by name.
TF32 is off, as in the JAX package's float32 step.  `--dtype bfloat16`
profiles the step computing in bf16 (parameters, gradients and AdamW
state stay float32).
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mvsdet_torch.data.prefetch import stage_batch
from mvsdet_torch.tools.profile_predict import (TOP, _busy_us, command_line,
                                                synthetic_scene)
from mvsdet_torch.training.loop import create_train_state, train_step

# the port's kernels by the names nvcc gives their entry points: (kernel,
# pass); K1 and K2 run two device kernels each
PORT_KERNELS = {
    "composite_tiles_segment_kernel": ("K1 composite_tiles", "segment pass"),
    "composite_tiles_combine_kernel": ("K1 composite_tiles", "combine"),
    "composite_tiles_bwd_segment_kernel": ("K2 composite_tiles_bwd",
                                           "segment pass"),
    "composite_tiles_bwd_kernel": ("K2 composite_tiles_bwd", "backward walk"),
    "weighted_gather_sum_kernel": ("K3 weighted_gather_sum", None),
    "dfeat_kernel": ("K4 weighted_gather_sum_dfeat", None),
    "dweight_kernel": ("K5 weighted_gather_sum_dweight", None),
    "lift_rows_kernel": ("K4/K5 index lift_rows", None)}


def _port_kernel(name: str):
    for key, label in PORT_KERNELS.items():
        if key in name:
            return label
    return None, None


def main() -> None:
    cfg, name, dtype = command_line(__doc__.split("\n")[0])
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    state = create_train_state(
        cfg, generator=torch.Generator().manual_seed(cfg.seed), dtype=dtype)
    batch = stage_batch(synthetic_scene(cfg, name, train=True), "cuda")

    def step() -> float:
        t0 = time.perf_counter()
        float(train_step(state, batch)["loss"])
        return (time.perf_counter() - t0) * 1e3

    warm = [step() for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        latency_ms = step()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    by_name, port, passes = {}, {}, {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        label, part = _port_kernel(e.name)
        if label:
            e_ms = e.time_range.elapsed_us() / 1e3
            ms, n = port.get(label, (0.0, 0))
            port[label] = (ms + e_ms, n + 1)
            if part:
                ms, n = passes.get((label, part), (0.0, 0))
                passes[label, part] = (ms + e_ms, n + 1)
    kernel_ms = sum(ms for ms, _ in by_name.values())
    host_reads = sum(n for name, (_, n) in by_name.items()
                     if name.startswith("Memcpy DtoH"))
    print(json.dumps({
        "config": name, "views": cfg.data.n_src_train, "dtype": str(dtype),
        "targets": cfg.data.nerf_target_views_train,
        "warmup_step_ms": warm, "latency_ms": latency_ms,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / latency_ms,
        "kernel_ms": kernel_ms, "device_events": len(kernels),
        "device_to_host_copies": host_reads,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
        flush=True)
    print(json.dumps({"port_kernels": {
        label: {"ms": ms, "launches": n, "passes": {
            part: {"ms": p_ms, "launches": p_n}
            for (lab, part), (p_ms, p_n) in sorted(passes.items())
            if lab == label}}
        for label, (ms, n) in sorted(port.items())}}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (ms, n) in top:
        print(json.dumps({"kernel": name[:120], "ms": ms, "launches": n,
                          "share": ms / kernel_ms}), flush=True)


if __name__ == "__main__":
    main()
