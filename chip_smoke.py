#!/usr/bin/env python3
"""Drive the port's predict path and training step on one NVIDIA card and
check them.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printed as one JSON line:

  device   the card's name and power limit (as nvidia-smi prints them, on
           a line of their own), torch and CUDA versions
  build    compile the five kernels from the four sources in
           `mvsdet_torch/ops/csrc` for sm_90a, one nvcc per source, all
           started together
  K1       the tile compositor against its plain version on random tables
           at the predict (T=80) and training (T=160) shapes, K=2048, C=3,
           30% empty slots: max abs error <= 1e-4
  K2       its backward against the plain version (autograd of the plain
           compositor) at T=160, K=2048, C=3, with a random cotangent whose
           transmittance row is not 0 (ScanNet's black background never
           exercises it) and slots clipped at alpha 0.99: max error
           <= 1e-4 of max |plain| for ddata and for dvals
  K3       the voxel-lift gather against its plain version and against
           F.embedding_bag at N=80, HW=4800, C=256, V=25600: max error
           <= 1e-5 of max |out|
  K4, K5   the gather's d-feat and d-weight against their plain versions
           at the training shape N=40, HW=4800, C=256, V=25600 with 10% of
           the weights nonzero: max error <= 1e-5 of max |plain| (d-feat
           adds with atomics, so its last bits vary from run to run)
  predict  `scannet_config()` at full width with random weights from a
           seeded generator, three synthetic scenes of 80 source views
           (240x320) and one target (120x160) through `make_predict_fn`,
           launch counts set to 0 just before and read just after (K1 and
           K3 once per scene, the backward kernels never); outputs finite
           and of the expected shapes; then one scene again with the plain
           versions in place of the kernels: rendered <= 1e-4, lifted
           volume <= 1e-5 relative, kept boxes and labels equal under the
           mask
  train    `scannet_config()` with seeded random weights, one synthetic
           scene of 40 source views (240x320) and 2 targets (120x160),
           3 steps through `fit`, launch counts set to 0 just before and
           read just after (each of K1-K5 once per step); each step's loss
           terms and latency, the steady step time and the peak memory;
           losses finite, the trained parameters moved, stem and layer1
           did not
  train_vs_plain
           one step's forward and backward from the same weights with the
           kernels, then with the plain versions, cuDNN deterministic:
           every loss term <= 1e-5 relative, every parameter's gradient
           <= 1e-4 (|delta| / |plain|)
  kernels  every kernel with its launches in the train run (and, for K1
           and K3, in the predict run), its error, its time, its plain
           version's time, its bound and the time of one PyTorch call
           computing the same function, at the inputs the train step gave
           it

The last line is {"ok": true, "device": {...}}.  Any failed check raises,
and the script exits non-zero without that line.  TF32 is off throughout
(the JAX package runs in float32 here).  Times come from CUDA events,
latencies from the host clock around work that ends in a copy to host.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
N_SCENES = 3
TRAIN_STEPS = 3
SOURCES = ("composite_tiles", "composite_tiles_bwd", "weighted_gather_sum",
           "weighted_gather_sum_bwd")


def emit(**fields):
    print(json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Median over `trials` of the mean CUDA-event time of `reps` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def random_tables(n_tiles: int, k: int, c: int, g: torch.Generator,
                  clipped: float = 0.0):
    """Tile tables in the compositor's layout, 30% of slots empty and a
    share `clipped` of them opaque enough to clip at alpha 0.99."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n_tiles, k, device="cuda",
                                           generator=g)
    data = torch.zeros(n_tiles, 8, k, device="cuda")
    data[:, 0], data[:, 1] = u(0, 160), u(0, 120 * n_tiles // 80)
    data[:, 2], data[:, 3], data[:, 4] = u(0.02, 0.3), u(-0.01, 0.01), \
        u(0.02, 0.3)
    opacity = torch.where(u(0, 1) < clipped, u(1.0, 1.5), u(0.0, 0.95))
    data[:, 5] = opacity * (u(0, 1) >= 0.3)
    vals = torch.rand(n_tiles, c, k, device="cuda", generator=g)
    return data, vals


def active_pairs(data: torch.Tensor, tiles_x: int) -> int:
    """(pixel, slot) pairs the compositor does not cull on this data."""
    from mvsdet_torch.ops.splat_kernel import (ALPHA_MAX, ALPHA_MIN,
                                               _tile_pixel_coords)
    n_tiles = data.shape[0]
    px, py = _tile_pixel_coords(n_tiles, tiles_x, data.device)
    active = 0
    for t0 in range(0, n_tiles, 16):
        d = data[t0:t0 + 16, :, None, :]
        dx = px[t0:t0 + 16, :, None] - d[:, 0]
        dy = py[t0:t0 + 16, :, None] - d[:, 1]
        power = -0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy) \
            - d[:, 3] * dx * dy
        alpha = torch.clamp_max(d[:, 5] * torch.exp(power.clamp_max(0.0)),
                                ALPHA_MAX)
        active += int(((power <= 0) & (alpha >= ALPHA_MIN)).sum())
    return active


def k1_bound(data: torch.Tensor, vals: torch.Tensor, tiles_x: int):
    """Least time for the compositor on these inputs: each table read
    once and the output written once, against 12 flops per (pixel, slot)
    pair to find whether it is culled plus 2C + 3 (accumulation, exp,
    log1p, the transmittance exp) per pair that this data leaves active."""
    from mvsdet_torch.ops.splat_kernel import PIXELS
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    ops = 12 * n_tiles * PIXELS * k + (2 * c + 3) * active_pairs(data,
                                                                 tiles_x)
    nbytes = 4 * (data.numel() + vals.numel() + n_tiles * (c + 1) * PIXELS)
    return bound(nbytes, ops)


def k2_bound(data: torch.Tensor, vals: torch.Tensor, tiles_x: int):
    """Least time for the compositor's backward on these inputs: the
    tables and the cotangent read once, ddata and dvals written once,
    against 12 flops per (pixel, slot) pair for the cull test plus, per
    active pair, 4C + 34 (three transcendentals, u, dalpha, the suffix
    sum, the six data-row terms, dvals, and the sums over the tile's
    pixels)."""
    from mvsdet_torch.ops.splat_kernel import PIXELS
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    ops = 12 * n_tiles * PIXELS * k + (4 * c + 34) * active_pairs(data,
                                                                  tiles_x)
    nbytes = 4 * (2 * data.numel() + 2 * vals.numel()
                  + n_tiles * (c + 1) * PIXELS)
    return bound(nbytes, ops)


def selected_rows(pix: torch.Tensor, hw: int, mask=None) -> int:
    """Distinct (view, pixel) rows that the (n, v) pairs in `mask` read."""
    n = pix.shape[0]
    flat = torch.arange(n, device=pix.device)[:, None] * hw + pix.long()
    return torch.unique(flat if mask is None else flat[mask]).numel()


def k3_bound(feat: torch.Tensor, pix: torch.Tensor, weight: torch.Tensor):
    """Least time for the gather on these inputs: the feature rows its
    nonzero weights select, read once, with pix and weight, and the
    output written once, against 2 flops per selected value."""
    n, hw, c = feat.shape
    nz = weight != 0
    nbytes = 4 * (selected_rows(pix, hw, nz) * c + 2 * pix.numel()
                  + pix.shape[1] * c)
    return bound(nbytes, 2 * c * int(nz.sum()))


def k4_bound(pix: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
             hw: int):
    """Least time for d-feat on these inputs: pix, weight and g read once,
    the (N, HW, C) output written once, against 2 flops per value of each
    nonzero-weight pair."""
    n, n_vox = pix.shape
    c = g.shape[1]
    nz = int((weight != 0).sum())
    nbytes = 4 * (2 * pix.numel() + g.numel() + n * hw * c)
    return bound(nbytes, 2 * c * nz)


def k5_bound(feat: torch.Tensor, pix: torch.Tensor, g: torch.Tensor):
    """Least time for d-weight on these inputs: the feature rows that
    every (n, v) pair selects, read once, with pix and g, and the (N, V)
    output written once, against 2 flops per value of every pair."""
    n, hw, c = feat.shape
    nbytes = 4 * (selected_rows(pix, hw) * c + pix.numel() + g.numel()
                  + pix.numel())
    return bound(nbytes, 2 * c * pix.numel())


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def embedding_bag_fn(feat, pix, weight):
    """One PyTorch call computing the gather: bags of the N views' rows
    per voxel (a yardstick only; the port never calls it)."""
    n, hw, c = feat.shape
    idx = (torch.arange(n, device=pix.device)[:, None] * hw
           + pix.long()).T.contiguous()
    table = feat.reshape(n * hw, c)
    w = weight.T.contiguous()
    return lambda: torch.nn.functional.embedding_bag(
        idx, table, per_sample_weights=w, mode="sum")


def embedding_bag_backward_fn(feat, pix, weight, g):
    """One autograd.grad of that embedding_bag: its d-table and
    d-per-sample-weights, the work of K4 and K5 together."""
    n, hw, c = feat.shape
    idx = (torch.arange(n, device=pix.device)[:, None] * hw
           + pix.long()).T.contiguous()
    table = feat.detach().reshape(n * hw, c).requires_grad_(True)
    w = weight.detach().T.contiguous().requires_grad_(True)
    out = torch.nn.functional.embedding_bag(idx, table, per_sample_weights=w,
                                            mode="sum")
    return lambda: torch.autograd.grad(out, (table, w), g, retain_graph=True)


class Recorder:
    """Stands in for a kernel wrapper at its call site: calls `fn` and
    keeps the first call's inputs and output.  A wrapper counts its own
    launches through its module's name for it, which then names the
    Recorder, so `launches` passes through to the wrapper."""

    def __init__(self, fn):
        self.fn = fn
        self.args = self.out = None

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args):
        out = self.fn(*args)
        if self.args is None:
            self.args, self.out = args, out
        return out


def detached(args):
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "mvsdet_torch").is_dir():
        print("chip_smoke: run from the root of the repository (the "
              "mvsdet_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    from mvsdet_torch.config import scannet_config
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.evaluation.harness import make_predict_fn
    from mvsdet_torch.models.mvsdet import build_model
    from mvsdet_torch.ops import (build, lift_kernel, splat_kernel,
                                  splat_tiles, voxel_lift)
    from mvsdet_torch.ops.lift_kernel import (
        weighted_gather_sum, weighted_gather_sum_dfeat,
        weighted_gather_sum_dfeat_reference, weighted_gather_sum_dweight,
        weighted_gather_sum_dweight_reference, weighted_gather_sum_reference)
    from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                               composite_tiles_bwd,
                                               composite_tiles_bwd_reference,
                                               composite_tiles_reference)
    from mvsdet_torch.training.loop import create_train_state, fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counted = {"composite_tiles": composite_tiles,
               "composite_tiles_bwd": composite_tiles_bwd,
               "weighted_gather_sum": weighted_gather_sum,
               "weighted_gather_sum_dfeat": weighted_gather_sum_dfeat,
               "weighted_gather_sum_dweight": weighted_gather_sum_dweight}

    def reset_launches():
        for fn in counted.values():
            fn.launches = 0

    # -- device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi,
         name=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build(SOURCES)
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs.values()],
         kernels=sorted(counted))

    g = torch.Generator(device="cuda").manual_seed(0)

    # -- K1 and K2 on random tables ------------------------------------
    for n_tiles in (80, 160):
        data, vals = random_tables(n_tiles, 2048, 3, g)
        err = (composite_tiles(data, vals, 10)
               - composite_tiles_reference(data, vals, 10)).abs().max().item()
        emit(phase="K1", tiles=n_tiles, k=2048, c=3, max_abs_err=err,
             ms=cuda_ms(lambda: composite_tiles(data, vals, 10)),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(
                 data, vals, 10), reps=3))
        check(err <= 1e-4, f"K1 at T={n_tiles}: max abs error {err} > 1e-4")

    data, vals = random_tables(160, 2048, 3, g, clipped=0.05)
    cot = torch.randn(160, 4, 256, device="cuda", generator=g)
    got = composite_tiles_bwd(data, vals, cot, 10)
    want = composite_tiles_bwd_reference(data, vals, cot, 10)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    emit(phase="K2", tiles=160, k=2048, c=3, ddata_rel_err=errs[0],
         dvals_rel_err=errs[1],
         ms=cuda_ms(lambda: composite_tiles_bwd(data, vals, cot, 10)),
         plain_ms=cuda_ms(lambda: composite_tiles_bwd_reference(
             data, vals, cot, 10), reps=3))
    check(max(errs) <= 1e-4, f"K2: errors {errs} > 1e-4 of max |plain|")
    check(bool((got[0][:, 6:] == 0).all()), "K2: ddata rows 6-7 not zero")
    del data, vals, cot, got, want

    # -- K3 on random inputs -------------------------------------------
    n, hw, c, v = 80, 4800, 256, 25600
    feat = torch.rand(n, hw, c, device="cuda", generator=g)
    pix = torch.randint(0, hw, (n, v), device="cuda", generator=g,
                        dtype=torch.int32)
    weight = torch.rand(n, v, device="cuda", generator=g) \
        * (torch.rand(n, v, device="cuda", generator=g) < 0.3)
    ref = weighted_gather_sum_reference(feat, pix, weight)
    rel = rel_err(weighted_gather_sum(feat, pix, weight), ref)
    emit(phase="K3", n=n, hw=hw, c=c, v=v, max_rel_err=rel,
         ms=cuda_ms(lambda: weighted_gather_sum(feat, pix, weight)),
         plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
             feat, pix, weight), reps=3),
         library_ms=cuda_ms(embedding_bag_fn(feat, pix, weight)))
    check(rel <= 1e-5, f"K3: relative error {rel} > 1e-5")
    del feat, pix, weight, ref

    # -- K4 and K5 on random inputs at the training shape ---------------
    n = 40
    feat = torch.rand(n, hw, c, device="cuda", generator=g)
    pix = torch.randint(0, hw, (n, v), device="cuda", generator=g,
                        dtype=torch.int32)
    weight = torch.rand(n, v, device="cuda", generator=g) \
        * (torch.rand(n, v, device="cuda", generator=g) < 0.1)
    cot = torch.randn(v, c, device="cuda", generator=g)
    k4_rel = rel_err(weighted_gather_sum_dfeat(pix, weight, cot, hw),
                     weighted_gather_sum_dfeat_reference(pix, weight, cot,
                                                         hw))
    k5_rel = rel_err(weighted_gather_sum_dweight(feat, pix, cot),
                     weighted_gather_sum_dweight_reference(feat, pix, cot))
    emit(phase="K4", n=n, hw=hw, c=c, v=v, max_rel_err=k4_rel,
         ms=cuda_ms(lambda: weighted_gather_sum_dfeat(pix, weight, cot, hw)),
         plain_ms=cuda_ms(lambda: weighted_gather_sum_dfeat_reference(
             pix, weight, cot, hw), reps=3))
    emit(phase="K5", n=n, hw=hw, c=c, v=v, max_rel_err=k5_rel,
         ms=cuda_ms(lambda: weighted_gather_sum_dweight(feat, pix, cot)),
         plain_ms=cuda_ms(lambda: weighted_gather_sum_dweight_reference(
             feat, pix, cot), reps=3))
    check(k4_rel <= 1e-5, f"K4: relative error {k4_rel} > 1e-5")
    check(k5_rel <= 1e-5, f"K5: relative error {k5_rel} > 1e-5")
    del feat, pix, weight, cot

    # -- predict at full ScanNet width ---------------------------------
    cfg = scannet_config()
    mc = cfg.model
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    predict = make_predict_fn(model)
    scenes = [make_synthetic_scene(cfg, seed=s, n_views=cfg.data.n_src_test,
                                   n_targets=cfg.data.nerf_target_views_test)
              for s in range(N_SCENES)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    preds = []
    for s, scene in enumerate(scenes):
        t0 = time.perf_counter()
        preds.append(predict(scene))
        emit(phase="predict", scene=s, latency_ms=(time.perf_counter() - t0)
             * 1e3, kept_boxes=int(preds[-1]["mask"].sum()))
    predict_launches = {name: fn.launches for name, fn in counted.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase="predict", scenes=N_SCENES, views=cfg.data.n_src_test,
         launches=predict_launches, peak_memory_gb=peak_gb)
    for name, count in predict_launches.items():
        want = N_SCENES if name in ("composite_tiles",
                                    "weighted_gather_sum") else 0
        check(count == want, f"{name} launched {count} times in "
                             f"{N_SCENES} predicts, expected {want}")
    md = mc.head.max_detections
    shapes = dict(boxes=(md, 6), scores=(md,), labels=(md,), mask=(md,),
                  rendered=(1,) + mc.target_size + (3,),
                  depth_expect=(cfg.data.n_src_test,) + mc.feature_size)
    for pred in preds:
        for key, shape in shapes.items():
            check(pred[key].shape == shape,
                  f"{key}: shape {pred[key].shape}, expected {shape}")
            check(np.all(np.isfinite(pred[key].astype(np.float64))),
                  f"{key}: not finite")

    # the same scene with the plain versions in place of the kernels;
    # bit-reproducible convolutions, so that the two predicts differ only
    # where the kernels and their plain versions differ
    torch.backends.cudnn.deterministic = True
    runs = {}
    for label, lift_fn, comp_fn in (
            ("kernel", weighted_gather_sum, composite_tiles),
            ("plain", weighted_gather_sum_reference,
             composite_tiles_reference)):
        lift, comp = Recorder(lift_fn), Recorder(comp_fn)
        with mock.patch.object(voxel_lift, "weighted_gather_sum", lift), \
                mock.patch.object(splat_tiles, "composite_tiles", comp):
            runs[label] = (predict(scenes[0]), lift, comp)
    (pk, lk, ck), (pp, lp, _) = runs["kernel"], runs["plain"]
    vol_rel = rel_err(lk.out, lp.out)
    rend_err = float(np.abs(pk["rendered"] - pp["rendered"]).max())
    mask_equal = bool(np.array_equal(pk["mask"], pp["mask"]))
    m = pk["mask"]
    boxes_equal = mask_equal and bool(
        np.array_equal(pk["labels"][m], pp["labels"][m])
        and np.allclose(pk["boxes"][m], pp["boxes"][m], rtol=1e-5,
                        atol=1e-5))
    emit(phase="predict_vs_plain", volume_max_rel_err=vol_rel,
         rendered_max_abs_err=rend_err, mask_equal=mask_equal,
         boxes_labels_equal_under_mask=boxes_equal, kept_boxes=int(m.sum()))
    check(rend_err <= 1e-4, f"rendered differs by {rend_err} > 1e-4")
    check(vol_rel <= 1e-5, f"lifted volume differs by {vol_rel} > 1e-5")
    check(boxes_equal, "kept boxes or labels differ under the mask")
    del model, predict, scenes, preds, runs, pk, pp, lk, lp, ck
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    # -- train at full ScanNet width -----------------------------------
    scene = make_synthetic_scene(cfg, seed=0, n_views=cfg.data.n_src_train,
                                 n_targets=cfg.data.nerf_target_views_train)
    state = create_train_state(
        cfg, device="cuda", generator=torch.Generator().manual_seed(cfg.seed))
    params0 = {k: p.detach().clone()
               for k, p in state.model.named_parameters()}
    step_logs = []
    t_start = [time.perf_counter()]

    def log_step(i, metrics):
        now = time.perf_counter()
        step_logs.append(dict(step=i, latency_ms=(now - t_start[0]) * 1e3,
                              **metrics))
        t_start[0] = now
        emit(phase="train", **step_logs[-1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_start[0] = time.perf_counter()
    fit(state, (scene for _ in range(TRAIN_STEPS)), TRAIN_STEPS, log_every=1,
        log_fn=log_step)
    train_launches = {name: fn.launches for name, fn in counted.items()}
    steady = [s["latency_ms"] for s in step_logs[1:]]
    emit(phase="train", steps=TRAIN_STEPS, views=cfg.data.n_src_train,
         targets=cfg.data.nerf_target_views_train, launches=train_launches,
         first_step_ms=step_logs[0]["latency_ms"],
         steady_step_ms=statistics.mean(steady),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name, count in train_launches.items():
        check(count == TRAIN_STEPS, f"{name} launched {count} times in "
                                    f"{TRAIN_STEPS} train steps")
    for log in step_logs:
        check(all(np.isfinite(v) for k, v in log.items()
                  if k not in ("step", "latency_ms")),
              f"step {log['step']}: a loss is not finite: {log}")
        check(log["loss_nvs"] > 0 and "cls_loss" in log,
              f"step {log['step']}: loss terms missing: {log}")
    moved = frozen_moved = 0
    for name, p in state.model.named_parameters():
        changed = not torch.equal(p.detach(), params0[name])
        if name.startswith(("backbone.stem_", "backbone.layer1_")):
            frozen_moved += changed
        else:
            moved += changed
    emit(phase="train", parameters_moved=moved, frozen_moved=frozen_moved)
    check(moved > 0.9 * sum(1 for n in params0 if not n.startswith(
        ("backbone.stem_", "backbone.layer1_"))),
        f"only {moved} trainable parameters moved")
    check(frozen_moved == 0, f"{frozen_moved} frozen parameters moved")
    del state, params0

    # -- one step with the kernels, then with the plain versions --------
    torch.backends.cudnn.deterministic = True
    base = create_train_state(
        cfg, device="cuda", generator=torch.Generator().manual_seed(cfg.seed))
    batch = {k: torch.as_tensor(v).cuda() for k, v in scene.items()}
    recorders = {}
    results = {}
    for label in ("kernel", "plain"):
        model = copy.deepcopy(base.model)
        if label == "kernel":
            rec = recorders = {
                "composite_tiles": (splat_tiles, Recorder(composite_tiles)),
                "composite_tiles_bwd": (splat_kernel,
                                        Recorder(composite_tiles_bwd)),
                "weighted_gather_sum": (voxel_lift,
                                        Recorder(weighted_gather_sum)),
                "weighted_gather_sum_dfeat": (
                    lift_kernel, Recorder(weighted_gather_sum_dfeat)),
                "weighted_gather_sum_dweight": (
                    lift_kernel, Recorder(weighted_gather_sum_dweight))}
        else:
            rec = {"composite_tiles": (splat_tiles, Recorder(
                       composite_tiles_reference)),
                   "weighted_gather_sum": (voxel_lift, Recorder(
                       weighted_gather_sum_reference))}
        patches = [mock.patch.object(mod, name, r)
                   for name, (mod, r) in rec.items()]
        for p in patches:
            p.start()
        try:
            total, aux = model.loss(batch)
            total.backward()
        finally:
            for p in patches:
                p.stop()
        results[label] = ({k: v.item() for k, v in aux.items()},
                          {k: p.grad for k, p in model.named_parameters()
                           if p.grad is not None})
        del model, total, aux
    (lk_, gk), (lp_, gp) = results["kernel"], results["plain"]
    loss_rel = {k: abs(lk_[k] - lp_[k]) / max(abs(lp_[k]), 1e-30)
                for k in lp_}
    check(set(gk) == set(gp), "the two runs give gradients to different "
                              "parameters")
    grad_rel = {k: (torch.linalg.vector_norm(gk[k] - gp[k])
                    / torch.linalg.vector_norm(gp[k]).clamp_min(1e-30)).item()
                for k in gp}
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
    emit(phase="train_vs_plain", loss_rel_err=loss_rel,
         max_grad_rel_err=worst[0][1], worst_grads=worst,
         n_grads=len(grad_rel))
    check(max(loss_rel.values()) <= 1e-5, f"loss terms differ: {loss_rel}")
    check(worst[0][1] <= 1e-4, f"gradients differ: {worst}")
    torch.backends.cudnn.deterministic = False
    del base, batch, results, gk, gp

    # -- kernels line ----------------------------------------------------
    args = {name: detached(r.args) for name, (_, r) in recorders.items()}
    k1_args = args["composite_tiles"]
    k2_args = args["composite_tiles_bwd"]
    k3_args = args["weighted_gather_sum"]
    k4_args = args["weighted_gather_sum_dfeat"]
    k5_args = args["weighted_gather_sum_dweight"]
    k1_ref = composite_tiles_reference(*k1_args)
    k1_err = (composite_tiles(*k1_args) - k1_ref).abs().max().item()
    k2_got = composite_tiles_bwd(*k2_args)
    k2_ref = composite_tiles_bwd_reference(*k2_args)
    k2_err = max((a - b).abs().max().item() for a, b in zip(k2_got, k2_ref))
    k2_tol = 1e-4 * max(b.abs().max().item() for b in k2_ref)
    k3_ref = weighted_gather_sum_reference(*k3_args)
    k3_err = (weighted_gather_sum(*k3_args) - k3_ref).abs().max().item()
    k4_ref = weighted_gather_sum_dfeat_reference(*k4_args)
    k4_err = (weighted_gather_sum_dfeat(*k4_args) - k4_ref).abs().max().item()
    k5_ref = weighted_gather_sum_dweight_reference(*k5_args)
    k5_err = (weighted_gather_sum_dweight(*k5_args) - k5_ref).abs().max() \
        .item()
    check(k1_err <= 1e-4, f"K1 on train inputs: {k1_err}")
    check(k2_err <= k2_tol, f"K2 on train inputs: {k2_err} > {k2_tol}")
    check(k3_err <= 1e-5 * k3_ref.abs().max().item(),
          f"K3 on train inputs: {k3_err}")
    check(k4_err <= 1e-5 * k4_ref.abs().max().item(),
          f"K4 on train inputs: {k4_err}")
    check(k5_err <= 1e-5 * k5_ref.abs().max().item(),
          f"K5 on train inputs: {k5_err}")
    del k1_ref, k2_got, k2_ref, k3_ref, k4_ref, k5_ref

    feat3, pix3, w3 = k3_args
    (pix4, w4, g4, hw4), (feat5, pix5, g5) = k4_args, k5_args
    lib_bwd_ms = cuda_ms(embedding_bag_backward_fn(feat3, pix3, w3, g4))
    k1_b, k1_by = k1_bound(*k1_args)
    k2_b, k2_by = k2_bound(k2_args[0], k2_args[1], k2_args[3])
    k3_b, k3_by = k3_bound(*k3_args)
    k4_b, k4_by = k4_bound(pix4, w4, g4, hw4)
    k5_b, k5_by = k5_bound(feat5, pix5, g5)
    lift_shape = dict(n=feat5.shape[0], hw=feat5.shape[1], c=feat5.shape[2],
                      v=pix5.shape[1], nonzero_weights=int((w4 != 0).sum()))
    kernels = [
        dict(name="composite_tiles", route="cuda",
             source="mvsdet_torch/ops/csrc/composite_tiles.cu",
             replaces="mvsdet_tpu/ops/pallas/splat_kernel.py:48",
             launches=train_launches["composite_tiles"],
             predict_launches=predict_launches["composite_tiles"],
             max_abs_err=k1_err,
             ms=cuda_ms(lambda: composite_tiles(*k1_args)),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(*k1_args),
                              reps=3),
             bound_ms=k1_b, bound_by=k1_by, library_ms=None,
             shape=dict(tiles=k1_args[0].shape[0], k=k1_args[0].shape[2],
                        c=k1_args[1].shape[1])),
        dict(name="composite_tiles_bwd", route="cuda",
             source="mvsdet_torch/ops/csrc/composite_tiles_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/splat_kernel.py:126",
             launches=train_launches["composite_tiles_bwd"],
             max_abs_err=k2_err,
             ms=cuda_ms(lambda: composite_tiles_bwd(*k2_args)),
             plain_ms=cuda_ms(lambda: composite_tiles_bwd_reference(
                 *k2_args), reps=3),
             bound_ms=k2_b, bound_by=k2_by, library_ms=None,
             shape=dict(tiles=k2_args[0].shape[0], k=k2_args[0].shape[2],
                        c=k2_args[1].shape[1])),
        dict(name="weighted_gather_sum", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:41",
             launches=train_launches["weighted_gather_sum"],
             predict_launches=predict_launches["weighted_gather_sum"],
             max_abs_err=k3_err,
             ms=cuda_ms(lambda: weighted_gather_sum(*k3_args)),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
                 *k3_args), reps=3),
             bound_ms=k3_b, bound_by=k3_by,
             library_ms=cuda_ms(embedding_bag_fn(*k3_args)),
             shape=dict(n=feat3.shape[0], hw=feat3.shape[1], c=feat3.shape[2],
                        v=pix3.shape[1],
                        nonzero_weights=int((w3 != 0).sum()))),
        dict(name="weighted_gather_sum_dfeat", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:62",
             launches=train_launches["weighted_gather_sum_dfeat"],
             max_abs_err=k4_err,
             ms=cuda_ms(lambda: weighted_gather_sum_dfeat(*k4_args)),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_dfeat_reference(
                 *k4_args), reps=3),
             bound_ms=k4_b, bound_by=k4_by, library_ms=lib_bwd_ms,
             library_covers="K4+K5: one autograd.grad of embedding_bag",
             shape=lift_shape),
        dict(name="weighted_gather_sum_dweight", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:82",
             launches=train_launches["weighted_gather_sum_dweight"],
             max_abs_err=k5_err,
             ms=cuda_ms(lambda: weighted_gather_sum_dweight(*k5_args)),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_dweight_reference(
                 *k5_args), reps=3),
             bound_ms=k5_b, bound_by=k5_by, library_ms=lib_bwd_ms,
             library_covers="K4+K5: one autograd.grad of embedding_bag",
             shape=lift_shape),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
