"""What a traced run reads: the device's busy time, the port's kernels
and the inputs each was given, the NMS's span, and the breakdown.

Frozen copies, from commit dafa6b3, of `_busy_us`
(mvsdet_torch/tools/profile_predict.py) and `PORT_KERNELS`
(mvsdet_torch/tools/profile_train.py), and of the NMS span between two
CUDA events that `profile_predict.py` records.  The wrappers are
installed from here, around the port's entry points, only for the traced
stretch, and removed after it.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Tuple

import torch

# the port's kernels by the names nvcc gives their entry points -> label
PORT_KERNELS = {
    "composite_tiles_segment_kernel": "K1",
    "composite_tiles_combine_kernel": "K1",
    "composite_tiles_bwd_segment_kernel": "K2",
    "composite_tiles_bwd_kernel": "K2",
    "weighted_gather_sum_kernel": "K3",
    "dfeat_kernel": "K4",
    "dweight_kernel": "K5",
    "lift_rows_kernel": "index"}
TOP = 10


def busy_us(intervals) -> float:
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


def port_kernel(name: str):
    """The label (K1 ... K5, index) of a device kernel's name, or None."""
    # the longest key first: "composite_tiles_bwd_segment_kernel" also
    # holds no shorter key, but "dfeat_kernel" must not take a longer name
    for key in sorted(PORT_KERNELS, key=len, reverse=True):
        if key in name:
            return PORT_KERNELS[key]
    return None


@contextlib.contextmanager
def patched(module, name: str, wrapper_of: Callable):
    """``module.name`` replaced by ``wrapper_of(original)`` (which keeps
    the original's attributes) for the block."""
    original = getattr(module, name)
    wrapper = functools.wraps(original)(wrapper_of(original))
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, original)


class KernelInputs:
    """Records the inputs of each port kernel launch while installed, by
    wrapping the port's entry points: K1 `splat_kernel._forward`, K2
    `splat_kernel.composite_tiles_bwd`, K3 `lift_kernel._forward`, the
    index `lift_kernel.lift_rows`, K4 `weighted_gather_sum_dfeat`, K5
    `weighted_gather_sum_dweight`."""

    def __init__(self):
        self.calls: List[Tuple[str, tuple]] = []

    def _recorder(self, label: str):
        def wrapper_of(fn):
            def call(*args, **kwargs):
                self.calls.append((label, args, kwargs))
                return fn(*args, **kwargs)
            return call
        return wrapper_of

    @contextlib.contextmanager
    def installed(self):
        from mvsdet_torch.ops import lift_kernel, splat_kernel
        with contextlib.ExitStack() as stack:
            for module, name, label in (
                    (splat_kernel, "_forward", "K1"),
                    (splat_kernel, "composite_tiles_bwd", "K2"),
                    (lift_kernel, "_forward", "K3"),
                    (lift_kernel, "lift_rows", "index"),
                    (lift_kernel, "weighted_gather_sum_dfeat", "K4"),
                    (lift_kernel, "weighted_gather_sum_dweight", "K5")):
                stack.enter_context(patched(module, name,
                                            self._recorder(label)))
            yield self

    def bounds_ms(self) -> Dict[str, float]:
        """Each kernel's summed least time over the recorded calls, from
        `benchmark/bounds.py` (only calls on the card)."""
        from benchmark import bounds as b
        out: Dict[str, float] = {}
        for label, args, kwargs in self.calls:
            if label == "K1":
                data, vals, tiles_x = args[:3]
                ms = b.k1_bound(data, vals, b.cull_counts(data, tiles_x))[0]
            elif label == "K2":
                data, vals, _, tiles_x = args[:4]
                ms = b.k2_bound(data, vals, b.cull_counts(data, tiles_x))[0]
            elif label == "K3":
                ms = b.k3_bound(*args[:3])[0]
            elif label == "index":
                ms = b.index_bound(args[0], args[1])[0]
            elif label == "K4":
                pix, weight, g, hw = args[:4]
                dtype = args[5] if len(args) > 5 else kwargs.get(
                    "dtype", torch.float32)
                ms = b.k4_bound(pix, weight, g, hw,
                                torch.finfo(dtype).bits // 8)[0]
            else:
                ms = b.k5_bound(*args[:3])[0]
            out[label] = out.get(label, 0.0) + ms
        return out


class NmsSpans:
    """The NMS's device span, between two CUDA events recorded around
    `aligned_3d_nms` / `rotated_3d_nms` where `models.head` calls them."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def installed(self):
        from mvsdet_torch.models import head

        def wrapper_of(fn):
            def call(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self.events.append((start, end))
                return out
            return call

        with patched(head, "aligned_3d_nms", wrapper_of), \
                patched(head, "rotated_3d_nms", wrapper_of):
            yield self

    def spans_ms(self) -> List[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def traced(fn: Callable[[], None]) -> dict:
    """Run ``fn`` under `torch.profiler` between two synchronises and
    return what the readers need: the host wall time of the stretch, the
    device kernels as (name, start_us, end_us) and the host operations as
    (name, start_us, end_us)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(item)
        else:
            host.append(item)
    return dict(wall_s=wall, kernels=kernels, host=host)


def breakdown(trace: dict) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps of the device, each named by the innermost host
    operation that was running at the gap's middle and the kernel that
    ended it; at most `TOP` of each, in seconds."""
    by_name: Dict[str, float] = {}
    for name, s, e in trace["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = sorted((s, e, name) for name, s, e in trace["kernels"])
    gaps, end = [], None
    for s, e, name in spans:
        if end is not None and s > end:
            gaps.append((s - end, end, s, name))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, reverse=True)[:TOP]
    idle = []
    for length, g0, g1, nxt in gaps:
        mid = (g0 + g1) / 2
        inner = min(((e - s, name) for name, s, e in trace["host"]
                     if s <= mid <= e),
                    default=(0, "host Python outside torch ops"))
        idle.append([f"{inner[1][:60]} (before {nxt[:40]})", length / 1e6])
    return {"device_ops": [[n[:100], s] for n, s in ops],
            "idle_gaps": idle}
