"""What the per-layer metrics' readers share (`benchmark/metrics/`).

Each reader gets the run's context: `mode` ("train" or "predict"), the
window's `window_s` and `items` (steps or predicts), `flops_per_item`
(`benchmark/flops.py`), `window_peak_bytes`, and from the traced stretch
`trace` (`benchmark/trace.traced`), `items_traced`, `kernel_bounds_ms`
and, for predict, `nms_ms`.  A reader returns None where its run has
nothing for it to read.
"""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark.bounds import PEAK_F32_S
from benchmark.trace import busy_us, port_kernel


def idle_share(ctx: dict, mode: str) -> Optional[float]:
    """% of the traced stretch's wall time in which no kernel ran."""
    if ctx.get("mode") != mode or "trace" not in ctx:
        return None
    t = ctx["trace"]
    busy = busy_us([(s, e) for _, s, e in t["kernels"]]) / 1e6
    return 100.0 * (1.0 - busy / t["wall_s"])


def mfu(ctx: dict, mode: str) -> Optional[float]:
    """% of the float32 peak: the FLOPs the window's scenes require over
    the window's wall time."""
    if ctx.get("mode") != mode or not ctx.get("items"):
        return None
    rate = ctx["flops_per_item"] * ctx["items"] / ctx["window_s"]
    return 100.0 * rate / PEAK_F32_S


def kernels_roofline(ctx: dict, mode: str) -> Optional[float]:
    """% : the port kernels' summed least times over their summed device
    times in the traced stretch."""
    if ctx.get("mode") != mode or "trace" not in ctx:
        return None
    device_ms = sum((e - s) / 1e3 for name, s, e in ctx["trace"]["kernels"]
                    if port_kernel(name))
    bound_ms = sum(ctx.get("kernel_bounds_ms", {}).values())
    if device_ms <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / device_ms


def nms_ms(ctx: dict) -> Optional[float]:
    """The median device span of the NMS over the traced predicts."""
    spans = ctx.get("nms_ms")
    return statistics.median(spans) if spans else None


def peak_mem_gb(ctx: dict, mode: str) -> Optional[float]:
    """The allocator's peak over the window, in GB."""
    if ctx.get("mode") != mode or not ctx.get("window_peak_bytes"):
        return None
    return ctx["window_peak_bytes"] / 1e9
