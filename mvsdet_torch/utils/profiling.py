"""Timing, tracing and memory helpers (port of mvsdet_tpu/utils/profiling.py).

`hard_sync` waits for a computation's completion, `timed` takes the
least time of a few calls (CUDA events on the card, the host clock on
the CPU), `dispatch_floor` is that time for a trivial call, `trace`
records a `torch.profiler` trace, `StepTimer` times steps after a
warm-up and summarises them, and `device_memory_stats` reads
`torch.cuda.memory_stats`.  The port's own profilers
(`tools/profile_train.py`, `tools/profile_predict.py`) stand beside
these.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Set

import numpy as np
import torch


def _leaves(out) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)


def _cuda_devices(out) -> Set[torch.device]:
    return {t.device for t in _leaves(out) if t.device.type == "cuda"}


def hard_sync(out):
    """Wait until the work that produced ``out`` (a tensor, or dicts,
    lists and tuples of them) has finished on every card it lies on, and
    return ``out``.  CPU tensors are complete when they are returned."""
    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)
    return out


def timed(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """The least seconds of ``iters`` calls of ``fn(*args)``, after
    ``warmup`` calls.  Where the warm-up's output lies on a card, each
    call is timed between two CUDA events on the current stream after a
    synchronisation (so the time is the device's, host launch gaps
    included); else on the host clock."""
    out = None
    for _ in range(warmup):
        out = hard_sync(fn(*args))
    if out is None:
        out = hard_sync(fn(*args))
    times = []
    if _cuda_devices(out):
        for _ in range(iters):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hard_sync(fn(*args))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            hard_sync(fn(*args))
            times.append(time.perf_counter() - t0)
    return min(times)


def dispatch_floor(iters: int = 5, device="cuda") -> float:
    """`timed` of one trivial add on ``device``: the floor every `timed`
    result there carries.  Report it beside micro-benchmark times."""
    a = torch.ones((8, 8), device=device)
    return timed(lambda a: a + 1.0, a, iters=iters)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a `torch.profiler` trace (host, and the card where there is
    one) of the enclosed code into ``log_dir/trace.json`` (Chrome trace
    format; chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with a warm-up skip and a percentile
    summary: each ``with timer:`` block is one step, and the first
    ``warmup`` steps are not kept."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        """mean_s, p50_s, p90_s, min_s and steps of the kept steps; {}
        when none was kept."""
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "min_s": float(t.min()),
            "steps": len(self._times),
        }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes in use and their peak on each card this process sees
    (`torch.cuda.memory_stats`, the caching allocator's counts); {}
    without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out
