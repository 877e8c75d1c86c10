"""The port's spans (`mvsdet_torch/utils/profiling.py`) and the benchmark's
readers of them (`benchmark/spans.py`, `benchmark/metrics/`), on the CPU
at `tiny_test_config()` with narrow FPN and neck widths:

- off, a span is one shared no-op: a `fit` step records nothing, opens no
  profiler range and reads no clock;
- inside `recording()`, one `fit` step and one `evaluate_scenes` scene
  give every span the layer boundaries promise, nested as the code nests
  them, with the step or scene as their item and the staging on its own
  thread; the recorder's durations match the profiler's ranges of the
  same spans;
- under a CPU `torch.profiler`, `benchmark.spans.attribute` gives every
  op of a training step a span, the backward's ops land on their forward
  layers, and the sweep's checkpoint recompute nests under
  `train_step.backward`;
- each new per-layer reader returns its value on a synthetic traced
  stretch and None where the spans are missing (a program without them).
"""

import dataclasses
import threading
import types

import pytest
import torch

from mvsdet_torch import config as port_config
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import evaluate_scenes, make_predict_fn
from mvsdet_torch.models.mvsdet import build_model
from mvsdet_torch.training import loop
from mvsdet_torch.utils import profiling

from benchmark import harness, spans

MODEL_SPANS = {"mvsdet.backbone", "mvsdet.sweep", "mvsdet.sample_depth",
               "mvsdet.lift", "mvsdet.neck", "mvsdet.gaussians",
               "mvsdet.head", "mvsdet.render"}
STEP_SPANS = MODEL_SPANS | {"fit.data_wait", "data.stage", "mvsdet.loss",
                            "train_step.forward", "train_step.backward",
                            "train_step.optimizer"}
SCENE_SPANS = (MODEL_SPANS | {"evaluate.data_wait", "evaluate.predict",
                              "evaluate.host_metrics", "data.stage",
                              "mvsdet.nms"})


def narrow(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, neck3d_out_channels=16,
        backbone=dataclasses.replace(cfg.model.backbone,
                                     fpn_out_channels=32)))


@pytest.fixture(scope="module")
def cfg():
    return narrow(port_config.tiny_test_config())


@pytest.fixture(scope="module")
def scene(cfg):
    return make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)


@pytest.fixture(scope="module")
def state(cfg, scene):
    # a sweep chunk of 2 of the 4 views: two checkpointed chunks
    state = loop.create_train_state(cfg, device="cpu", sweep_chunk=2)
    loop.fit(state, [scene], 1)
    return state


def step(state, scene):
    loop.fit(state, [scene], 1)


def by_id(recorded):
    return {s.id: s for s in recorded}


def ancestors(s, ids):
    out = []
    while s.parent is not None:
        s = ids[s.parent]
        out.append(s.name)
    return out


# -- the recorder ------------------------------------------------------------

def test_off_records_nothing_opens_no_range_and_reads_no_clock(
        state, scene, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while the spans are off")

    # the range a live span opens (torch's optimizer opens its own
    # `record_function` ranges whatever the port does)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter_ns=refuse))
    assert profiling.span("a") is profiling.span("b")
    before = list(profiling._REC.spans)
    step(state, scene)
    assert list(profiling._REC.spans) == before


def test_a_fit_step_records_its_spans(state, scene):
    first = state.step
    with profiling.recording() as recorded:
        step(state, scene)
    names = {s.name for s in recorded}
    assert names == STEP_SPANS
    ids = by_id(recorded)
    main = threading.get_ident()
    for s in recorded:
        assert s.start_ns <= s.end_ns
        assert s.item == first
        if s.name == "data.stage":
            assert s.thread != main and s.parent is None
        else:
            assert s.thread == main
    for s in recorded:
        up = ancestors(s, ids)
        if s.name in MODEL_SPANS - {"mvsdet.sweep"} or s.name == "mvsdet.loss":
            assert up == ["train_step.forward"], (s.name, up)
    sweeps = [ancestors(s, ids) for s in recorded if s.name == "mvsdet.sweep"]
    # the call, its two chunks inside it, and the two chunks' recompute,
    # which the CPU runs inside backward on the step's own thread
    assert sorted(sweeps) == sorted(
        [["train_step.forward"]] + [["mvsdet.sweep", "train_step.forward"]] * 2
        + [["train_step.backward"]] * 2)
    for phase in ("fit.data_wait", "train_step.forward",
                  "train_step.backward", "train_step.optimizer"):
        assert [ancestors(s, ids) for s in recorded if s.name == phase] \
            == [[]]


def test_an_evaluated_scene_records_its_spans(cfg, scene):
    model = build_model(cfg, device="cpu")
    predict_fn = make_predict_fn(model, "cpu")
    with profiling.recording() as recorded:
        evaluate_scenes(predict_fn, [scene], cfg.model.head.n_classes,
                        device="cpu")
    assert {s.name for s in recorded} == SCENE_SPANS
    ids = by_id(recorded)
    count = {}
    last_wait = max((s for s in recorded if s.name == "evaluate.data_wait"),
                    key=lambda s: s.start_ns)
    for s in recorded:
        count[s.name] = count.get(s.name, 0) + 1
        # the last wait finds no scene 1
        assert s.item == (1 if s is last_wait else 0), s.name
        if s.name in MODEL_SPANS - {"mvsdet.sweep"}:
            assert ancestors(s, ids) == ["evaluate.predict"], s.name
    assert ancestors(next(s for s in recorded if s.name == "mvsdet.nms"),
                     ids) == ["evaluate.predict"]
    # the scene's wait and the one that finds the scenes at an end
    assert count["evaluate.data_wait"] == 2
    assert count["evaluate.predict"] == count["evaluate.host_metrics"] == 1


def test_recording_from_threads_and_its_bound(monkeypatch):
    def work(k):
        for _ in range(50):
            with profiling.span(f"t{k}"):
                with profiling.span(f"t{k}.inner"):
                    pass

    with profiling.recording() as recorded:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(recorded) == 400 and recorded.dropped == 0
    ids = by_id(recorded)
    for s in recorded:
        if s.name.endswith(".inner"):
            parent = ids[s.parent]
            assert parent.name == s.name[:-len(".inner")]
            assert parent.thread == s.thread
    with pytest.raises(RuntimeError):
        with profiling.recording():
            with profiling.recording():
                pass
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording() as recorded:
        work(0)
    assert len(recorded) == 3 and recorded.dropped == 97


def test_recorder_durations_match_the_profilers_ranges(state, scene):
    from torch.profiler import ProfilerActivity, profile
    with profiling.recording() as recorded, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, scene)
    ranges = {}
    for e in prof.events():
        if e.name in STEP_SPANS:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end - e.time_range.start))
    kept = {}
    for s in recorded:
        kept.setdefault(s.name, []).append((s.start_ns, s.seconds * 1e6))
    # the profiler traces the thread that started it (not the staging one)
    assert set(ranges) == STEP_SPANS - {"data.stage"}
    for name, got in ranges.items():
        want = sorted(kept[name])
        assert len(got) == len(want), name
        for (_, p), (_, r) in zip(sorted(got), want):
            # the range opens before the recorder reads its clock and
            # closes after
            assert -5.0 <= p - r <= 2e3 + 0.05 * p, (name, p, r)


# -- the attribution ---------------------------------------------------------

def test_every_op_of_a_step_has_a_span_and_backward_its_layer(state, scene):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, scene)
    events = prof.events()
    attributed = spans.attribute(events)
    ops = [(u, name) for u, name in attributed if u.name.startswith("aten::")]
    assert ops and all(name is not None for _, name in ops)
    nodes = spans._Timeline([e for e in events
                             if e.name.startswith(spans.NODE)])
    backward = {name for u, name in ops
                if nodes.at(u.time_range.start) is not None}
    assert {"mvsdet.backbone", "mvsdet.sweep", "mvsdet.neck", "mvsdet.head",
            "mvsdet.render", "mvsdet.loss"} <= backward
    assert spans.summary(attributed, 1.0, 1)["no_span_share"] == 0.0
    # what stays with backward itself: the gradient accumulation
    time = {}
    for u, name in ops:
        if nodes.at(u.time_range.start) is not None:
            own = name == "train_step.backward"
            time[own] = time.get(own, 0.0) + (u.time_range.end
                                               - u.time_range.start)
    assert time[True] < 0.25 * time[False], time
    # the recompute of each checkpointed chunk runs inside backward
    backs = [e for e in events if e.name == "train_step.backward"]
    inside = [e for e in events if e.name == "mvsdet.sweep" and any(
        b.time_range.start <= e.time_range.start <= b.time_range.end
        for b in backs)]
    assert len(inside) == 2


# -- the readers -------------------------------------------------------------

def flat_trace():
    """Two traced predicts' and two steps' worth of host ranges, runtime
    calls and kernels (us): a wait, a sweep launching two kernels, an NMS
    launching three, host metrics, syncs."""
    host, kernels = [], []
    for base in (0.0, 1000.0):
        host += [("fit.data_wait", base, base + 2.0 + base / 100),
                 ("evaluate.data_wait", base, base + 4.0 + base / 50),
                 ("evaluate.predict", base + 10, base + 500),
                 ("train_step.forward", base + 10, base + 500),
                 ("mvsdet.sweep", base + 20, base + 100),
                 ("mvsdet.sweep", base + 30, base + 90),
                 ("cudaLaunchKernel", base + 40, base + 41),
                 ("cudaLaunchKernelExC_v11060", base + 50, base + 51),
                 ("mvsdet.nms", base + 200, base + 300)]
        host += [("cuLaunchKernel", base + 210 + i, base + 211 + i)
                 for i in range(3)]
        host += [("cudaStreamSynchronize", base + 400, base + 401),
                 ("cudaMemcpyAsync", base + 402, base + 403),
                 ("evaluate.host_metrics", base + 600, base + 700),
                 ("cudaStreamSynchronize", base + 800, base + 801),
                 ("aten::add", base + 40, base + 42)]
        kernels += [("conv", base + 45, base + 75),
                    ("gemm", base + 80, base + 90),
                    ("Memcpy DtoH (Device -> Pageable)", base + 402,
                     base + 403)]
        kernels += [("nms", base + 220 + i, base + 221 + i)
                    for i in range(3)]
    return dict(wall_s=2e-3, host=host, kernels=kernels)


EXPECTED = {"data_wait_ms.train": 12.0e-3, "launches.train": 5.0,
            "host_syncs.train": 1.0, "data_wait_ms.predict": 24.0e-3,
            "host_metrics_ms.predict": 0.1, "sweep_ms.predict": 40.0e-3,
            "nms_launches.predict": 3.0, "host_syncs.predict": 1.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_traced_stretch(name):
    mode = name.split(".")[1]
    ctx = dict(mode=mode, trace=flat_trace(), items_traced=2)
    assert harness.reader(name)(ctx) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_the_spans_reads_nothing(name):
    mode = name.split(".")[1]
    trace = flat_trace()
    trace["host"] = [h for h in trace["host"]
                     if h[0] not in spans.PROGRAM_SPANS]
    read = harness.reader(name)
    assert read(dict(mode=mode, trace=trace, items_traced=2)) is None
    assert read(dict(mode="other", trace=flat_trace(),
                     items_traced=2)) is None
    assert read(dict(mode=mode, window_s=1.0, items=3)) is None


def test_kernels_are_paired_with_launches_only_where_their_counts_agree():
    trace = flat_trace()
    assert spans.device_ms_under(trace, "mvsdet.sweep") == pytest.approx(
        80e-3)
    extra = dict(trace, kernels=trace["kernels"] + [("k", 1500.0, 1501.0)])
    assert spans.device_ms_under(extra, "mvsdet.sweep") is None
    copies = dict(trace, kernels=trace["kernels"] + [
        ("Memset (Device)", 1500.0, 1501.0)])
    assert spans.device_ms_under(copies, "mvsdet.sweep") == pytest.approx(
        80e-3)
