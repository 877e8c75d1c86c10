"""The program's spans in a profiler trace.

The port marks its layers with `mvsdet_torch.utils.profiling.span`; under
`torch.profiler` each span is a `record_function` range on the host
(`PROGRAM_SPANS` are their names).  Two readings of a trace here:

- `attribute` takes the profiler's whole events (`prof.events()`) and
  gives each unit of work the innermost program span it belongs to: on
  the card each device event, by the runtime call that launched it
  (their shared correlation id), on the CPU each outermost aten op.
  Work inside an autograd node belongs to the span of the forward op
  the node differentiates (the node's `sequence_nr` on its
  `fwd_thread`), so a layer's backward counts to the layer; a span
  opened inside a node (the sweep's checkpoint recompute) takes its own
  work.  `python -m benchmark.span_report` prints it for a cell.
- The per-layer readers get only the traced stretch's flat lists
  (`benchmark/trace.traced`: host events and device events, each as
  (name, start_us, end_us), no threads).  `ranges_ms`, `calls_under` and
  `device_ms_under` read those: a runtime call belongs to every span
  whose range holds its start, and a kernel to the span that holds its
  launch, the launch paired with the kernel by their order (one stream
  runs its kernels in the order they were launched).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PROGRAM_SPANS = (
    "fit.data_wait", "train_step.forward", "train_step.backward",
    "train_step.optimizer", "data.stage", "evaluate.data_wait",
    "evaluate.predict", "evaluate.host_metrics", "mvsdet.backbone",
    "mvsdet.sweep", "mvsdet.sample_depth", "mvsdet.lift", "mvsdet.neck",
    "mvsdet.gaussians", "mvsdet.head", "mvsdet.render", "mvsdet.loss",
    "mvsdet.nms")
# host runtime and driver calls, by their names without the version
# suffix the profiler may add (`cudaLaunchKernelExC_v11060`): those that
# launch one kernel each, and those that wait for the card (a read of
# device memory to the host is a copy and one of these)
LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel"))
SYNCS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH", "cuMemcpy"))
NODE = "autograd::engine::evaluate_function"


def call_kind(name: str, kinds: frozenset) -> bool:
    """Whether the host call ``name`` is one of ``kinds``."""
    return name.split("_")[0] in kinds

Range = Tuple[float, float]


# -- the flat lists of a traced stretch --------------------------------------

def _union(ranges: Iterable[Range]) -> List[Range]:
    out: List[list] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _holds(union: List[Range], starts: List[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


def ranges_ms(trace: dict, name: str) -> List[float]:
    """The durations (ms) of the host ranges named ``name`` in start
    order, a range inside another of its name merged into it (the sweep
    opens one around its chunks' own)."""
    return [(e - s) / 1e3 for s, e in
            _union((s, e) for n, s, e in trace["host"] if n == name)]


def calls_under(trace: dict, calls: frozenset,
                names: Sequence[str] = PROGRAM_SPANS) -> Optional[int]:
    """How many host calls named in ``calls`` start inside a range of
    ``names``; None where the trace holds no such range."""
    union = _union((s, e) for n, s, e in trace["host"] if n in names)
    if not union:
        return None
    starts = [s for s, _ in union]
    return sum(1 for n, s, _ in trace["host"]
               if call_kind(n, calls) and _holds(union, starts, s))


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def device_ms_under(trace: dict, name: str) -> Optional[float]:
    """Device time (ms) of the kernels launched inside a range named
    ``name``.  Each kernel is paired with its launch by order, which can
    swap near neighbours but holds over a span's hundreds of launches;
    None where the counts of launches and kernels differ, so that the
    order cannot pair them, or no range is named so."""
    union = _union((s, e) for n, s, e in trace["host"] if n == name)
    launches = sorted(s for n, s, _ in trace["host"]
                      if call_kind(n, LAUNCHES))
    kernels = sorted((s, e) for n, s, e in trace["kernels"]
                     if _is_kernel(n))
    if not union or len(launches) != len(kernels):
        return None
    starts = [s for s, _ in union]
    return sum(e - s for t, (s, e) in zip(launches, kernels)
               if _holds(union, starts, t)) / 1e3


def _traced(ctx: dict, mode: str) -> Optional[dict]:
    if ctx.get("mode") != mode or "trace" not in ctx \
            or not ctx.get("items_traced"):
        return None
    return ctx["trace"]


def wait_ms(ctx: dict, mode: str, name: str) -> Optional[float]:
    """The mean of the waits named ``name`` for the traced stretch's items
    after its first (the first wait fills the pipeline, which a window
    pays once)."""
    trace = _traced(ctx, mode)
    waits = ranges_ms(trace, name)[1:ctx["items_traced"]] if trace else []
    return sum(waits) / len(waits) if waits else None


def span_ms(ctx: dict, mode: str, name: str) -> Optional[float]:
    """The host time (ms) in ranges named ``name`` an item."""
    trace = _traced(ctx, mode)
    spent = ranges_ms(trace, name) if trace else []
    return sum(spent) / ctx["items_traced"] if spent else None


def calls_per_item(ctx: dict, mode: str, calls: frozenset,
                   names: Sequence[str] = PROGRAM_SPANS) -> Optional[float]:
    """`calls_under` an item."""
    trace = _traced(ctx, mode)
    count = calls_under(trace, calls, names) if trace else None
    return None if count is None else count / ctx["items_traced"]


def device_ms_per_item(ctx: dict, mode: str, name: str) -> Optional[float]:
    """`device_ms_under` an item."""
    trace = _traced(ctx, mode)
    ms = device_ms_under(trace, name) if trace else None
    return None if ms is None else ms / ctx["items_traced"]


# -- the whole events of a profiler ------------------------------------------

class _Timeline:
    """The innermost of properly nested ranges at any time on one
    thread."""

    def __init__(self, frames):
        points = sorted([(f.time_range.start, 1, -f.time_range.end, i)
                         for i, f in enumerate(frames)]
                        + [(f.time_range.end, 0, 0, i)
                           for i, f in enumerate(frames)])
        self.times: List[float] = []
        self.inner: List[Optional[object]] = []
        stack: List[int] = []
        for t, opening, _, i in points:
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            self.times.append(t)
            self.inner.append(frames[stack[-1]] if stack else None)

    def at(self, t: float):
        i = bisect.bisect_right(self.times, t) - 1
        return self.inner[i] if i >= 0 else None


def attribute(events, names: Sequence[str] = PROGRAM_SPANS
              ) -> List[Tuple[object, Optional[str]]]:
    """(unit, span name or None) for each unit of work in ``events``
    (`torch.profiler.profile.events()`): each device event where there
    are any, else each aten op not inside another on its thread; and each
    host runtime call (launches and waits), as a unit of its own."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    # device events, less the copies of host annotations (`record_function`
    # ranges) the profiler lays on the device timeline
    device = [e for e in events if e.device_type != DeviceType.CPU
              and "annotation" not in str(getattr(e, "activity_type", ""))]
    by_thread: Dict[int, list] = {}
    for e in host:
        by_thread.setdefault(e.thread, []).append(e)

    spans, frames, forward = {}, {}, {}
    for th, evs in by_thread.items():
        own = [e for e in evs if e.name in names]
        nodes = [e for e in evs if e.name.startswith(NODE)]
        spans[th] = _Timeline(own)
        frames[th] = _Timeline(own + nodes)
        # the op that made each autograd node: the last op outside every
        # node that read the node's sequence number (ops inside it read
        # the next one)
        in_node = _Timeline(nodes)
        for e in evs:
            key = (e.sequence_nr, th)
            if e.sequence_nr >= 0 and in_node.at(e.time_range.start) is None \
                    and (key not in forward or e.time_range.start
                         > forward[key].time_range.start):
                forward[key] = e
    # the thread whose forward an autograd thread differentiates
    owner = {}
    for e in host:
        if e.name.startswith(NODE) and e.fwd_thread:
            owner.setdefault(e.thread, e.fwd_thread)

    def span_at(th: int, t: float) -> Optional[str]:
        tl = spans.get(th)
        f = tl.at(t) if tl else None
        return f.name if f is not None else None

    def where(th: int, t: float) -> Optional[str]:
        tl = frames.get(th)
        f = tl.at(t) if tl else None
        if f is None:
            return span_at(owner[th], t) if th in owner else None
        if f.name in names:
            return f.name
        op = forward.get((f.sequence_nr, f.fwd_thread))
        if op is not None:
            name = span_at(op.thread, op.time_range.start)
            if name is not None:
                return name
        # a node no forward op made (gradient accumulation)
        return span_at(th, t) or (span_at(owner[th], t)
                                  if th in owner else None)

    # the runtime and driver calls: launches, copies, waits
    calls = [e for e in host if e.name.startswith("cu")]
    out = [(c, where(c.thread, c.time_range.start)) for c in calls
           if call_kind(c.name, LAUNCHES | SYNCS)]
    if device:
        by_corr = {c.id: c for c in calls}
        for k in device:
            c = by_corr.get(k.id)
            out.append((k, where(c.thread, c.time_range.start)
                        if c is not None else None))
        return out
    for th, evs in by_thread.items():
        end = float("-inf")
        for e in sorted((e for e in evs if e.name.startswith("aten::")),
                        key=lambda e: (e.time_range.start,
                                       -e.time_range.end)):
            if e.time_range.start >= end:
                out.append((e, where(th, e.time_range.start)))
                end = e.time_range.end
    return out


def summary(attributed, wall_us: float, items: int) -> dict:
    """Per span and per item: device ms (or host op ms on the CPU),
    kernel launches and host syncs; the share of device time under no
    span; the syncs' spans."""
    per: Dict[str, Dict[str, float]] = {}
    busy = unnamed = 0.0
    for unit, name in attributed:
        row = per.setdefault(name or "(no span)",
                             {"ms": 0.0, "launches": 0, "syncs": 0})
        if call_kind(unit.name, LAUNCHES):
            row["launches"] += 1
        elif call_kind(unit.name, SYNCS):
            row["syncs"] += 1
        else:
            ms = (unit.time_range.end - unit.time_range.start) / 1e3
            row["ms"] += ms
            busy += ms
            unnamed += ms if name is None else 0.0
    rows = {k: {m: v / items for m, v in r.items()} for k, r in per.items()}
    return {"per_item": rows, "busy_ms_per_item": busy / items,
            "wall_ms_per_item": wall_us / 1e3 / items,
            "no_span_share": unnamed / busy if busy else None}
