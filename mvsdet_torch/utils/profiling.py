"""Timing, memory and span helpers (port of mvsdet_tpu/utils/profiling.py).

`hard_sync` waits for a computation's completion, `timed` takes the
least time of a few calls (CUDA events on the card, the host clock on
the CPU), and `device_memory_stats` reads `torch.cuda.memory_stats`.

`span(name)` marks a stretch of the program: the data waits of `fit` and
`evaluate_scenes`, the phases of `train_step`, the staging thread's
`stage_batch`, the layers of `MVSDet` and the NMS.  A span is live only
while `recording()` is on or a `torch.profiler` traces the process;
otherwise it is one shared no-op context, returned after one check.
Inside `recording()` each span is kept (name, thread, parent, item,
start and end on `time.perf_counter_ns`); under a profiler it is also a
host range on the profiler's clock beside the kernels it launches, an op
range (`_RecordFunctionFast`), not the user annotation `record_function`
makes: the profiler copies an annotation onto the device timeline as a
device event, which a reader of the trace would take for a kernel.
`item(i)` sets the step or scene that the spans opened after it belong
to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional, Set

import torch
from torch.autograd import profiler as _torch_profiler

# the most spans one `recording()` keeps; later ones are counted, not kept
MAX_SPANS = 1 << 20


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span: ``parent`` is the ``id`` of the span that was
    innermost on the same thread when it opened (None at the thread's
    top); ``item`` the step or scene set by `item` (None before any)."""
    id: int
    name: str
    thread: int
    parent: Optional[int]
    item: Optional[int]
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Spans(list):
    """The spans of one `recording()` block in the order they closed;
    ``dropped`` counts those past `MAX_SPANS`."""
    dropped = 0


class _Recorder:
    def __init__(self):
        self.on = False
        self.item: Optional[int] = None
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.local = threading.local()
        self.spans = Spans()        # the current `recording()`'s

    def stack(self) -> List[int]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, span: Span, spans: Spans) -> None:
        with self.lock:
            if len(spans) < MAX_SPANS:
                spans.append(span)
            else:
                spans.dropped += 1


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Live:
    """A span that is live: kept while recording, a host range while a
    profiler is active."""

    __slots__ = ("name", "spans", "id", "parent", "item", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.spans = rec.spans if rec.on else None
        if self.spans is not None:
            stack = rec.stack()
            self.parent = stack[-1] if stack else None
            self.id = next(rec.ids)
            self.item = rec.item
            stack.append(self.id)
        self.range = None
        if _torch_profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.spans is not None:
            _REC.stack().pop()
            _REC.add(Span(self.id, self.name, threading.get_ident(),
                          self.parent, self.item, self.start, end),
                     self.spans)
        return False


def span(name: str):
    """A context marking ``name``'s stretch of the program: live while
    `recording()` is on or a `torch.profiler` is active, else a shared
    no-op."""
    if _REC.on or _torch_profiler._is_profiler_enabled:
        return _Live(name)
    return _OFF


def item(index: Optional[int]) -> None:
    """The step or scene that spans opened from now on belong to (on
    every thread)."""
    _REC.item = index


@contextlib.contextmanager
def recording() -> Iterator[Spans]:
    """Keep every span that closes inside the block in the yielded list,
    to be read when the block ends.  Blocks do not nest."""
    if _REC.on:
        raise RuntimeError("recording() is already on")
    spans = _REC.spans = Spans()
    _REC.on = True
    try:
        yield spans
    finally:
        _REC.on = False


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
