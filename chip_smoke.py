#!/usr/bin/env python3
"""Drive the port's predict path and training step on one NVIDIA card, in
the ScanNet and the ARKit configurations, and check them.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printed as one JSON line:

  device   the card's name and power limit (as nvidia-smi prints them, on
           a line of their own), torch and CUDA versions
  build    compile the five kernels and the lift backward's row index
           from the four sources in `mvsdet_torch/ops/csrc` (and the
           header the compositor's two share) for sm_90a, one nvcc per
           source, all started together
  K1       the tile compositor against its plain version on random tables
           at the predict (T=80) and training (T=160) shapes, K=2048, C=3,
           30% empty slots: max abs error <= 1e-4, and a second launch
           bit-equal to the first
  K2       its backward against the plain version (autograd of the plain
           compositor) at T=160, K=2048, C=3, with a random cotangent whose
           transmittance row is not 0 (ScanNet's black background never
           exercises it) and slots clipped at alpha 0.99: max error
           <= 1e-4 of max |plain| for ddata and for dvals, and a second
           launch bit-equal to the first
  K3       the voxel-lift gather against its plain version and against
           F.embedding_bag at N=80, HW=4800, C=256, V=25600: bit-equal to
           the plain version and to a second launch
  K3_bf16  its bf16-feature variant on the same inputs in bf16: bit-equal
           to the plain version, to a second launch and to the float32
           kernel on the rows widened to float32
  K4_K5    the gather's backward at the training shape N=40, HW=4800,
           C=256, V=25600 with 10% of the weights nonzero, pix uniform and
           clipped-heavy (55% of the pairs on 1% of the rows): the pairs'
           row index (`lift_rows`) equal to `lift_rows_reference`; d-feat
           (K4) and d-weight (K5) within 1e-5 of max |plain|, K4 bit-equal
           to its plain version in its own order and to a second launch;
           the feature rows K5 loads, counted on the card, at least the
           distinct rows the pairs select and at most one per pair
  K4_K5_bf16
           the bf16 variants on the same inputs with bf16 feature rows:
           K4's bf16 d-feat bit-equal to its plain version in its own order
           (rounded once) and to a second launch, and within one bf16 ulp
           (2^-7 of the value, plus 1e-5 of max |plain|) of the float32
           index_add_ plain version; K5 within 1e-5 of max |plain|
           and bit-equal to the float32 kernel on the widened rows
  predict  `scannet_config()` at full width with random weights from a
           seeded generator, three synthetic scenes of 80 source views
           (240x320) and one target (120x160) through `make_predict_fn`,
           launch counts set to 0 just before and read just after (K1 and
           K3 once per scene, the backward kernels never); outputs finite
           and of the expected shapes; then one scene again with the plain
           versions in place of the kernels (`predict_vs_plain`): rendered
           <= 1e-4, lifted volume <= 1e-5 relative, kept boxes and labels
           equal under the mask.  Run in float32, then with the model
           computing in bf16 (`dtype` in each line), where every K3
           launch is its bf16 variant
  train    `scannet_config()` with seeded random weights, one synthetic
           scene of 40 source views (240x320) and 2 targets (120x160),
           3 steps through `fit`, launch counts set to 0 just before and
           read just after (each of K1-K5 and the index once per step);
           each step's loss terms and latency, the steady step time and
           the peak memory;
           losses finite, the trained parameters moved, stem and layer1
           did not, parameters, statistics and AdamW state float32
  train_vs_plain
           one step's forward and backward from the same weights with the
           kernels, then with the plain versions, cuDNN deterministic:
           every loss term <= 1e-5 relative, every parameter's gradient
           <= 1e-4 (|delta| / |plain|).  Both run in float32, then in bf16,
           where K3, K4 and K5 run their bf16 variants once per step; in
           bf16 a gradient <= 2.5e-2 and all of them together <= 1e-2
           (K4's one-ulp roundings, spread by the bf16 backward), beside
           their distance from the float32 run's gradients
  arkit_predict
           `arkit_config()` at full width (per-view intrinsics, the yaw
           head, 17 classes) with seeded random weights, three synthetic
           ARKit scenes of 100 source views (the preset's 101 test views
           less the target; each view its own K) and one target through
           `make_predict_fn`, as `predict` (K1 and K3 once per scene,
           boxes (256, 7) after the exact rotated NMS), and
           `arkit_predict_vs_plain` as `predict_vs_plain`; float32, then
           bf16
  arkit_train
           `arkit_config()`, one synthetic ARKit scene of 40 source views
           and 2 targets (each its own K), 3 steps through `fit` as
           `train` (each of K1-K5 and the index once per step), and
           `arkit_train_vs_plain` with the tolerances of `train_vs_plain`;
           float32, then bf16
  batch_norm_train
           `train` and `train_vs_plain` (float32) for `scannet_config()`
           with CostRegNet in BatchNorm mode (`cost_reg_norm="batch"`: one
           sweep chunk of all 40 views, no checkpoint), the step times and
           the peak memory among them
  batch_norm_statistics
           every running statistic after the kernels' step of
           `batch_norm_train_vs_plain` within 1e-6 of the plain versions'
           step, CostRegNet's 14 all moved, and equal (1e-6) to those
           after the forward alone: backward does not move them again
  cull     the compositor kernels' own cull boxes (`cull_boxes`) on the
           tables the predict and the training step gave K1, taken through
           the recorders: the slots `cull_boxes_reference` keeps, boxes
           within 1e-3 px of its boxes, no active pair outside its slot's
           box; and the work the cull leaves (pairs in a box, listed
           (warp patch, slot) pairs, per-CTA load)
  kernels  every kernel (K1-K5 and the lift backward's row index,
           `lift_rows`) with its launches in the train run (and, for K1
           and K3, in the predict run), its error, its time queued behind
           a device wait (`ms`) and host-paced as before the wait was added
           (`host_paced_ms`), its plain version's time, its bound and the
           time of one PyTorch call computing the same function, at the
           inputs the train step gave it; K1's time on the predict's
           tables; for K1 and K2 also the bound that charges the cull test
           to every pair (`all_pairs_bound_ms`, the count before the
           kernels culled by box); for K4 and K5 (each timed with its own
           index build, as a wrapper called alone builds it) the index
           alone (`index_ms`), one backward of the lift's autograd
           Function (`backward_ms`: the index once, K4, K5) and the
           feature rows K5 loads (`feature_row_loads`, counted on the card
           by the kernel itself); then the bf16 variants of K3, K4 and K5
           with their launches in the bf16 runs, on the inputs the bf16
           step gave them (bounds count 2 bytes a bf16 value); then K3
           and its bf16 variant on the inputs the float32 and the bf16
           predict gave them (80 views), with their launches in the
           predict runs (`weighted_gather_sum_predict`,
           `weighted_gather_sum_bf16_predict`), and on the inputs the
           ARKit predicts gave them (100 views,
           `weighted_gather_sum_arkit_predict`,
           `weighted_gather_sum_bf16_arkit_predict`).  Every K3 row is
           bit-equal to its plain version, and each bf16 K3 row to the
           float32 kernel on the widened rows

    python3 chip_smoke.py --save-kernel-inputs PATH

also saves the inputs the step and the predict gave K1, K2, K3, K4 and K5
(and the bf16 step and predict K3, the bf16 step K4 and K5), on which
`mvsdet_torch/tools/time_kernels.py` times those kernels of any checkout
with this script's `cuda_ms`.

The last line is {"ok": true, "device": {...}}.  Any failed check raises,
and the script exits non-zero without that line.  TF32 is off throughout
(the JAX package's float32 runs in full float32).  Times come from CUDA events,
latencies from the host clock around work that ends in a copy to host.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
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
# ~5 ms of device time at the H100's 1.98 GHz boost clock: more than the
# host takes to enqueue one trial of `cuda_ms`
QUEUE_AHEAD_CYCLES = 10_000_000
# autograd's host cost per backward is ~0.2 ms: 8 of them queue behind the
# wait, 20 would not
BACKWARD_REPS = 8
SOURCES = ("composite_tiles", "composite_tiles_bwd", "weighted_gather_sum",
           "weighted_gather_sum_bwd")


def emit(**fields):
    print(json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int = 20, trials: int = 5,
            queued: bool = True) -> float:
    """Median over `trials` of the mean CUDA-event time of `reps` calls.

    With `queued`, each trial waits behind a device sleep of
    QUEUE_AHEAD_CYCLES, so the host has enqueued its launches before the
    first one starts and a kernel shorter than the wrapper's host cost is
    timed on the device.  Without it (how the kernels were timed before the
    wait was added), a call is timed at the rate the host issues it: the
    wrapper's host cost, where that is longer than the kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        if queued:
            torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
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


def bf16_rounding_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far a bf16 result is from a float32 one computed in another
    order, as a share of one bf16 ulp of the value (at most 2^-7 of it)
    plus 1e-5 of the largest (the float32 sums' order, where they
    cancel).  About 0.5 at most when got is want rounded to bf16."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    allowed = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
    return ((got - want).abs() / allowed.clamp_min(1e-30)).max().item()


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


def active_chunks(data: torch.Tensor, tiles_x: int, step: int = 16):
    """The compositor's active mask on this data, `step` tiles at a time:
    (first tile, (n, 256, K) mask, (n, 256) px, (n, 256) py)."""
    from mvsdet_torch.ops.splat_kernel import (ALPHA_MAX, ALPHA_MIN,
                                               _tile_pixel_coords)
    n_tiles = data.shape[0]
    px, py = _tile_pixel_coords(n_tiles, tiles_x, data.device)
    for t0 in range(0, n_tiles, step):
        d = data[t0:t0 + step, :, None, :]
        dx = px[t0:t0 + step, :, None] - d[:, 0]
        dy = py[t0:t0 + step, :, None] - d[:, 1]
        power = -0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy) \
            - d[:, 3] * dx * dy
        alpha = torch.clamp_max(d[:, 5] * torch.exp(power.clamp_max(0.0)),
                                ALPHA_MAX)
        yield (t0, (power <= 0) & (alpha >= ALPHA_MIN), px[t0:t0 + step],
               py[t0:t0 + step])


def cull_check(data: torch.Tensor, tiles_x: int) -> dict:
    """The kernels' own cull (`cull_boxes`) on these tables: whether it
    keeps the slots `cull_boxes_reference` keeps and how far its boxes
    are from the reference's; active pairs, active pairs outside their
    slot's box or in a dropped slot (must be 0), pairs in a kept slot's
    box; the (8x4-pixel warp patch, slot) pairs the kernels list (a kept
    box meets the patch) and how evenly the (tile, segment) CTAs share
    the listed and the active pairs."""
    from mvsdet_torch.ops.splat_kernel import (PIXELS, SEGMENT, TILE,
                                               cull_boxes,
                                               cull_boxes_reference)
    n_tiles, _, k = data.shape
    keep, box = cull_boxes(data)
    want_keep, want_box = cull_boxes_reference(data)
    kept = keep[:, None].expand_as(box)
    box_diff = float((box[kept] - want_box[kept]).nan_to_num(nan=0.0)
                     .abs().max()) if bool(keep.any()) else 0.0
    active = outside = in_box = 0
    active_slot = torch.zeros(n_tiles, k, device=data.device)
    for t0, act, px, py in active_chunks(data, tiles_x):
        b = box[t0:t0 + act.shape[0], :, None, :]
        x, y = px[..., None], py[..., None]
        inside = keep[t0:t0 + act.shape[0], None, :] \
            & (x >= b[:, 0]) & (x <= b[:, 1]) & (y >= b[:, 2]) \
            & (y <= b[:, 3])
        active += int(act.sum())
        outside += int((act & ~inside).sum())
        in_box += int(inside.sum())
        active_slot[t0:t0 + act.shape[0]] = act.sum(1)
    t = torch.arange(n_tiles, device=data.device)
    w = torch.arange(8, device=data.device)
    x0 = (((t % tiles_x) * TILE)[:, None] + (w % 2) * 8)[..., None].float()
    y0 = (((t // tiles_x) * TILE)[:, None] + (w // 2) * 4)[..., None].float()
    b = box[:, None]                                          # (T, 1, 4, K)
    listed = (keep[:, None] & (b[:, :, 0] <= x0 + 7) & (b[:, :, 1] >= x0)
              & (b[:, :, 2] <= y0 + 3) & (b[:, :, 3] >= y0)).sum(1)
    n_seg = -(-k // SEGMENT)

    def per_cta(x):                                           # (T, K) -> CTAs
        return torch.nn.functional.pad(x.float(), (0, n_seg * SEGMENT - k)) \
            .reshape(n_tiles, n_seg, SEGMENT).sum(-1).flatten()

    listed_cta, active_cta = per_cta(listed), per_cta(active_slot)
    pairs = n_tiles * PIXELS * k
    return dict(keep_equals_reference=bool(torch.equal(keep, want_keep)),
                box_max_abs_diff_from_reference=box_diff,
                active_pairs=active, active_outside_box=outside,
                in_box_pairs=in_box, active_share=active / pairs,
                in_box_share=in_box / pairs, kept_slots=int(keep.sum()),
                kept_slot_share=float(keep.float().mean()),
                listed_warp_slots=int(listed.sum()),
                listed_lane_use=active / max(32 * int(listed.sum()), 1),
                ctas=n_tiles * n_seg,
                ctas_with_no_listed_slot=int((listed_cta == 0).sum()),
                listed_per_cta_mean=float(listed_cta.mean()),
                listed_per_cta_max=float(listed_cta.max()),
                active_per_cta_mean=float(active_cta.mean()),
                active_per_cta_max=float(active_cta.max()))


def check_cull(cull: dict, tables: str):
    check(cull["active_outside_box"] == 0,
          f"{tables} tables: {cull['active_outside_box']} active pairs "
          f"outside their cull box")
    check(cull["keep_equals_reference"],
          f"{tables} tables: the kernels keep other slots than "
          f"cull_boxes_reference")
    check(cull["box_max_abs_diff_from_reference"] <= 1e-3,
          f"{tables} tables: the kernels' boxes differ from "
          f"cull_boxes_reference by {cull['box_max_abs_diff_from_reference']}"
          f" px")


def k1_bound(data: torch.Tensor, vals: torch.Tensor, cull: dict,
             all_pairs: bool = False):
    """Least time for the compositor on these inputs: each table read once
    and the output written once, against 12 flops to test whether a
    (pixel, slot) pair is active, for each pair in a kept slot's cull box
    (`cull_check`: every other pair is culled by its slot's box, computed
    once per slot), plus 2C + 3 (accumulation, exp, log1p, the
    transmittance exp) per pair that this data leaves active.  With
    `all_pairs`, the test is charged to every pair, as the bound was
    counted before the kernels culled by box."""
    from mvsdet_torch.ops.splat_kernel import PIXELS
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    tested = n_tiles * PIXELS * k if all_pairs else cull["in_box_pairs"]
    ops = 12 * tested + (2 * c + 3) * cull["active_pairs"]
    nbytes = 4 * (data.numel() + vals.numel() + n_tiles * (c + 1) * PIXELS)
    return bound(nbytes, ops)


def k2_bound(data: torch.Tensor, vals: torch.Tensor, cull: dict,
             all_pairs: bool = False):
    """Least time for the compositor's backward on these inputs: the
    tables and the cotangent read once, ddata and dvals written once,
    against the 12-flop test per pair in a kept slot's box (per pair with
    `all_pairs`, as in `k1_bound`) plus, per active pair, 4C + 34 (three
    transcendentals, u, dalpha, the suffix sum, the six data-row terms,
    dvals, and the sums over the tile's pixels)."""
    from mvsdet_torch.ops.splat_kernel import PIXELS
    n_tiles, _, k = data.shape
    c = vals.shape[1]
    tested = n_tiles * PIXELS * k if all_pairs else cull["in_box_pairs"]
    ops = 12 * tested + (4 * c + 34) * cull["active_pairs"]
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
    nonzero weights select, read once (4 or 2 bytes a value), with pix and
    weight, and the float32 output written once, against 2 flops per
    selected value."""
    n, hw, c = feat.shape
    nz = weight != 0
    nbytes = (selected_rows(pix, hw, nz) * c * feat.element_size()
              + 4 * (2 * pix.numel() + pix.shape[1] * c))
    return bound(nbytes, 2 * c * int(nz.sum()))


def k4_bound(pix: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
             hw: int, out_bytes: int = 4):
    """Least time for d-feat on these inputs: pix, weight and g read once,
    the (N, HW, C) output written once (`out_bytes` a value: 4, or 2 in
    bf16), against 2 flops per value of each nonzero-weight pair."""
    n, n_vox = pix.shape
    c = g.shape[1]
    nz = int((weight != 0).sum())
    nbytes = 4 * (2 * pix.numel() + g.numel()) + out_bytes * n * hw * c
    return bound(nbytes, 2 * c * nz)


def k5_bound(feat: torch.Tensor, pix: torch.Tensor, g: torch.Tensor):
    """Least time for d-weight on these inputs: the feature rows that
    every (n, v) pair selects, read once (4 or 2 bytes a value), with pix
    and g, and the (N, V) output written once, against 2 flops per value
    of every pair."""
    n, hw, c = feat.shape
    nbytes = (selected_rows(pix, hw) * c * feat.element_size()
              + 4 * (pix.numel() + g.numel() + pix.numel()))
    return bound(nbytes, 2 * c * pix.numel())


def index_bound(pix: torch.Tensor, hw: int):
    """Least time for the row index: pix read once, row_start and pair
    written once (a counting sort's integer work is not the limit)."""
    n, n_vox = pix.shape
    return bound(4 * (2 * n * n_vox + n * hw + 1), 0)


def k5_row_loads(dweight, feat, pix, g, rows) -> int:
    """The feature rows K5 (`dweight`) loads on these inputs, as the kernel
    counts them on the card in one more launch."""
    loads = torch.zeros(1, dtype=torch.int32, device="cuda")
    dweight(feat, pix, g, rows, loads)
    n_loads = int(loads.item())
    check(selected_rows(pix, feat.shape[1]) <= n_loads <= pix.numel(),
          f"K5 counted {n_loads} feature-row loads: fewer than the rows "
          f"its pairs select, or more than one per pair")
    return n_loads


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def embedding_bag_fn(feat, pix, weight):
    """One PyTorch call computing the gather: bags of the N views' rows
    per voxel (a yardstick only; the port never calls it).  On bf16 rows
    it takes bf16 weights and sums into bf16, its only bf16 form."""
    n, hw, c = feat.shape
    idx = (torch.arange(n, device=pix.device)[:, None] * hw
           + pix.long()).T.contiguous()
    table = feat.reshape(n * hw, c)
    w = weight.T.contiguous().to(feat.dtype)     # it takes the table's type
    return lambda: torch.nn.functional.embedding_bag(
        idx, table, per_sample_weights=w, mode="sum")


def lift_backward_inputs(kind: str, n: int, hw: int, c: int, v: int,
                         g: torch.Generator):
    """feat, pix, weight (10% nonzero) and a cotangent on the card.  pix is
    uniform, or for `clipped` 55% of each view's pairs fall on its first
    1% of rows, as the voxels outside a view clip onto its edge pixels."""
    feat = torch.rand(n, hw, c, device="cuda", generator=g)
    pix = torch.randint(0, hw, (n, v), device="cuda", generator=g,
                        dtype=torch.int32)
    if kind == "clipped":
        edge = torch.randint(0, hw // 100, (n, v), device="cuda",
                             generator=g, dtype=torch.int32)
        pix = torch.where(torch.rand(n, v, device="cuda", generator=g)
                          < 0.55, edge, pix)
    weight = torch.rand(n, v, device="cuda", generator=g) \
        * (torch.rand(n, v, device="cuda", generator=g) < 0.1)
    cot = torch.randn(v, c, device="cuda", generator=g)
    return feat, pix, weight, cot


def lift_backward_fn(gather, feat, pix, weight, g):
    """One backward of `gather`'s autograd Function on these inputs (in
    this port: the row index once, K4 and K5), through autograd.grad."""
    f = feat.detach().requires_grad_(True)
    w = weight.detach().requires_grad_(True)
    out = gather(f, pix, w)
    return lambda: torch.autograd.grad(out, (f, w), g, retain_graph=True)


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
    Recorder, so `launches` and `bf16_launches` pass through to the
    wrapper."""

    def __init__(self, fn):
        self.fn = fn
        self.args = self.out = None

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    @property
    def bf16_launches(self):
        return self.fn.bf16_launches

    @bf16_launches.setter
    def bf16_launches(self, n):
        self.fn.bf16_launches = n

    def __call__(self, *args):
        out = self.fn(*args)
        if self.args is None:
            self.args, self.out = args, out
        return out


def running_stats(model) -> dict:
    """Copies of a model's BatchNorm running means and variances."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def detached(args):
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--save-kernel-inputs", metavar="PATH",
        help="also torch.save the inputs the training step and the predict "
             "gave K1-K5, the bf16 step K3, K4 and K5 and the bf16 predict "
             "K3 (for mvsdet_torch/tools/time_kernels.py)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "mvsdet_torch").is_dir():
        print("chip_smoke: run from the root of the repository (the "
              "mvsdet_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    from mvsdet_torch.config import arkit_config, scannet_config
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.evaluation.harness import make_predict_fn
    from mvsdet_torch.models.mvsdet import build_model
    from mvsdet_torch.ops import (build, lift_kernel, splat_kernel,
                                  splat_tiles, voxel_lift)
    from mvsdet_torch.ops.lift_kernel import (
        lift_rows, lift_rows_reference, weighted_gather_sum,
        weighted_gather_sum_dfeat, weighted_gather_sum_dfeat_reference,
        weighted_gather_sum_dfeat_rows_reference, weighted_gather_sum_dweight,
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
               "weighted_gather_sum_dweight": weighted_gather_sum_dweight,
               "lift_rows": lift_rows}

    # the wrappers whose bf16 variants count their own launches too
    counted_bf16 = {name: fn for name, fn in counted.items()
                    if hasattr(fn, "bf16_launches")}

    def reset_launches():
        for fn in counted.values():
            fn.launches = 0
        for fn in counted_bf16.values():
            fn.bf16_launches = 0

    def read_launches():
        return ({name: fn.launches for name, fn in counted.items()},
                {name: fn.bf16_launches for name, fn in counted_bf16.items()})

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
        got = composite_tiles(data, vals, 10)
        err = (got - composite_tiles_reference(data, vals, 10)).abs().max() \
            .item()
        same = torch.equal(got, composite_tiles(data, vals, 10))
        emit(phase="K1", tiles=n_tiles, k=2048, c=3, max_abs_err=err,
             bit_equal_relaunch=same,
             ms=cuda_ms(lambda: composite_tiles(data, vals, 10)),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(
                 data, vals, 10), reps=3))
        check(err <= 1e-4, f"K1 at T={n_tiles}: max abs error {err} > 1e-4")
        check(same, f"K1 at T={n_tiles}: two launches differ")

    data, vals = random_tables(160, 2048, 3, g, clipped=0.05)
    cot = torch.randn(160, 4, 256, device="cuda", generator=g)
    got = composite_tiles_bwd(data, vals, cot, 10)
    want = composite_tiles_bwd_reference(data, vals, cot, 10)
    again = composite_tiles_bwd(data, vals, cot, 10)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    emit(phase="K2", tiles=160, k=2048, c=3, ddata_rel_err=errs[0],
         dvals_rel_err=errs[1], bit_equal_relaunch=same,
         ms=cuda_ms(lambda: composite_tiles_bwd(data, vals, cot, 10)),
         plain_ms=cuda_ms(lambda: composite_tiles_bwd_reference(
             data, vals, cot, 10), reps=3))
    check(max(errs) <= 1e-4, f"K2: errors {errs} > 1e-4 of max |plain|")
    check(bool((got[0][:, 6:] == 0).all()), "K2: ddata rows 6-7 not zero")
    check(same, "K2: two launches differ")
    del data, vals, cot, got, want, again

    # -- K3 on random inputs -------------------------------------------
    n, hw, c, v = 80, 4800, 256, 25600
    feat = torch.rand(n, hw, c, device="cuda", generator=g)
    pix = torch.randint(0, hw, (n, v), device="cuda", generator=g,
                        dtype=torch.int32)
    weight = torch.rand(n, v, device="cuda", generator=g) \
        * (torch.rand(n, v, device="cuda", generator=g) < 0.3)
    ref = weighted_gather_sum_reference(feat, pix, weight)
    got = weighted_gather_sum(feat, pix, weight)
    rel = rel_err(got, ref)
    same = torch.equal(got, weighted_gather_sum(feat, pix, weight))
    emit(phase="K3", n=n, hw=hw, c=c, v=v, max_rel_err=rel,
         bit_equal_relaunch=same,
         ms=cuda_ms(lambda: weighted_gather_sum(feat, pix, weight)),
         plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
             feat, pix, weight), reps=3),
         library_ms=cuda_ms(embedding_bag_fn(feat, pix, weight)))
    check(rel == 0, f"K3: relative error {rel}, not bit-equal")
    check(same, "K3: two launches differ")
    feat16 = feat.to(torch.bfloat16)
    got = weighted_gather_sum(feat16, pix, weight)
    rel = rel_err(got, weighted_gather_sum_reference(feat16, pix, weight))
    again = torch.equal(got, weighted_gather_sum(feat16, pix, weight))
    same = torch.equal(got, weighted_gather_sum(feat16.float(), pix, weight))
    emit(phase="K3_bf16", n=n, hw=hw, c=c, v=v, max_rel_err=rel,
         bit_equal_relaunch=again,
         equals_float32_kernel_on_widened_rows=same,
         ms=cuda_ms(lambda: weighted_gather_sum(feat16, pix, weight)),
         plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
             feat16, pix, weight), reps=3),
         library_ms=cuda_ms(embedding_bag_fn(feat16, pix, weight)))
    check(rel == 0, f"K3 bf16: relative error {rel}, not bit-equal")
    check(again, "K3 bf16: two launches differ")
    check(same, "K3 bf16 differs from the float32 kernel on the widened rows")
    del feat, feat16, pix, weight, ref, got

    # -- K4 and K5 on random inputs at the training shape ---------------
    n = 40
    for kind in ("uniform", "clipped"):
        feat, pix, weight, cot = lift_backward_inputs(kind, n, hw, c, v, g)
        rows = lift_rows(pix, hw, True)
        index_equal = all(torch.equal(a, b) for a, b in zip(
            rows, lift_rows_reference(pix, hw)))
        dfeat = weighted_gather_sum_dfeat(pix, weight, cot, hw, rows)
        same = torch.equal(dfeat, weighted_gather_sum_dfeat(pix, weight, cot,
                                                            hw))
        in_order = torch.equal(dfeat, weighted_gather_sum_dfeat_rows_reference(
            rows, weight, cot, hw))
        k4_rel = rel_err(dfeat, weighted_gather_sum_dfeat_reference(
            pix, weight, cot, hw))
        k5_rel = rel_err(weighted_gather_sum_dweight(feat, pix, cot, rows),
                         weighted_gather_sum_dweight_reference(feat, pix, cot))
        emit(phase="K4_K5", case=kind, n=n, hw=hw, c=c, v=v,
             index_equals_reference=index_equal, k4_max_rel_err=k4_rel,
             k4_bit_equal_relaunch=same, k4_equals_rows_reference=in_order,
             k5_max_rel_err=k5_rel,
             index_ms=cuda_ms(lambda: lift_rows(pix, hw)),
             k4_ms=cuda_ms(lambda: weighted_gather_sum_dfeat(pix, weight, cot,
                                                             hw)),
             k5_ms=cuda_ms(lambda: weighted_gather_sum_dweight(feat, pix,
                                                               cot)),
             k4_plain_ms=cuda_ms(lambda: weighted_gather_sum_dfeat_reference(
                 pix, weight, cot, hw), reps=3),
             k5_plain_ms=cuda_ms(lambda: weighted_gather_sum_dweight_reference(
                 feat, pix, cot), reps=3),
             feature_row_loads=k5_row_loads(weighted_gather_sum_dweight,
                                            feat, pix, cot, rows))
        check(index_equal, f"{kind}: the row index differs from "
                           f"lift_rows_reference")
        check(same, f"{kind}: two K4 launches differ")
        check(in_order, f"{kind}: K4 differs from its plain version in its "
                        f"own order")
        check(k4_rel <= 1e-5, f"{kind}: K4 relative error {k4_rel} > 1e-5")
        check(k5_rel <= 1e-5, f"{kind}: K5 relative error {k5_rel} > 1e-5")

        # the bf16 variants: d-feat rounded once to bf16, d-weight from
        # bf16 rows
        bf16 = torch.bfloat16
        feat16 = feat.to(bf16)
        dfeat16 = weighted_gather_sum_dfeat(pix, weight, cot, hw, rows, bf16)
        same = torch.equal(dfeat16, weighted_gather_sum_dfeat(
            pix, weight, cot, hw, None, bf16))
        in_order = torch.equal(dfeat16, weighted_gather_sum_dfeat_rows_reference(
            rows, weight, cot, hw, bf16))
        k4_share = bf16_rounding_share(
            dfeat16, weighted_gather_sum_dfeat_reference(pix, weight, cot,
                                                         hw))
        dw16 = weighted_gather_sum_dweight(feat16, pix, cot, rows)
        k5_rel = rel_err(dw16, weighted_gather_sum_dweight_reference(
            feat16, pix, cot))
        k5_wide = torch.equal(dw16, weighted_gather_sum_dweight(
            feat16.float(), pix, cot, rows))
        emit(phase="K4_K5_bf16", case=kind, n=n, hw=hw, c=c, v=v,
             k4_bit_equal_relaunch=same, k4_equals_rows_reference=in_order,
             k4_rounding_share=k4_share, k5_max_rel_err=k5_rel,
             k5_equals_float32_kernel_on_widened_rows=k5_wide,
             k4_ms=cuda_ms(lambda: weighted_gather_sum_dfeat(
                 pix, weight, cot, hw, None, bf16)),
             k5_ms=cuda_ms(lambda: weighted_gather_sum_dweight(feat16, pix,
                                                               cot)),
             k4_plain_ms=cuda_ms(lambda: weighted_gather_sum_dfeat_reference(
                 pix, weight, cot, hw, bf16), reps=3),
             k5_plain_ms=cuda_ms(lambda: weighted_gather_sum_dweight_reference(
                 feat16, pix, cot), reps=3),
             feature_row_loads=k5_row_loads(weighted_gather_sum_dweight,
                                            feat16, pix, cot, rows))
        check(same, f"{kind}: two bf16 K4 launches differ")
        check(in_order, f"{kind}: bf16 K4 differs from its plain version in "
                        f"its own order")
        check(k4_share <= 1, f"{kind}: bf16 K4 is {k4_share} bf16 ulps "
                             f"from its float32 plain version")
        check(k5_rel <= 1e-5, f"{kind}: bf16 K5 relative error {k5_rel}")
        check(k5_wide, f"{kind}: bf16 K5 differs from the float32 kernel on "
                       f"the widened rows")
    del feat, feat16, pix, weight, cot, rows, dfeat, dfeat16, dw16

    # -- predict and train at full ScanNet width, float32 then bf16 -----
    cfg = scannet_config()
    bf16 = torch.bfloat16
    frozen_prefixes = ("backbone.stem_", "backbone.layer1_")

    def check_launches(launches, bf16_launches, want, want_bf16, run):
        for name, count in launches.items():
            check(count == want[name], f"{run}: {name} launched {count} "
                                       f"times, expected {want[name]}")
        for name, count in bf16_launches.items():
            check(count == want_bf16[name],
                  f"{run}: {name}'s bf16 variant launched {count} times, "
                  f"expected {want_bf16[name]}")

    def predict_phases(cfg, scenes, dtype, phase="predict"):
        """A predict of each scene through make_predict_fn with the launch
        counts set to 0 just before and read just after, then the first
        scene with the kernels against it with the plain versions.
        Returns the launches and the inputs K1 and K3 got."""
        label = str(dtype).replace("torch.", "")
        mc = cfg.model
        n_scenes = len(scenes)
        model = build_model(cfg, device="cuda", dtype=dtype,
                            generator=torch.Generator().manual_seed(cfg.seed))
        predict = make_predict_fn(model)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        preds = []
        for s, scene in enumerate(scenes):
            t0 = time.perf_counter()
            preds.append(predict(scene))
            emit(phase=phase, dtype=label, scene=s,
                 latency_ms=(time.perf_counter() - t0) * 1e3,
                 kept_boxes=int(preds[-1]["mask"].sum()))
        launches, bf16_launches = read_launches()
        emit(phase=phase, dtype=label, scenes=n_scenes,
             views=cfg.data.n_src_test, launches=launches,
             bf16_launches=bf16_launches,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        check_launches(
            launches, bf16_launches,
            {name: n_scenes if name in ("composite_tiles",
                                        "weighted_gather_sum") else 0
             for name in launches},
            {name: n_scenes if (name == "weighted_gather_sum"
                                and dtype == bf16) else 0
             for name in bf16_launches}, f"{n_scenes} {label} {phase}s")
        md = mc.head.max_detections
        box_dim = 7 if mc.head.with_yaw else 6
        shapes = dict(boxes=(md, box_dim), scores=(md,), labels=(md,),
                      mask=(md,),
                      rendered=(1,) + mc.target_size + (3,),
                      depth_expect=(cfg.data.n_src_test,) + mc.feature_size)
        for pred in preds:
            for key, shape in shapes.items():
                check(pred[key].shape == shape,
                      f"{key}: shape {pred[key].shape}, expected {shape}")
                check(np.all(np.isfinite(pred[key].astype(np.float64))),
                      f"{key}: not finite")

        # the same scene with the plain versions in place of the kernels;
        # bit-reproducible convolutions, so that the two predicts differ
        # only where the kernels and their plain versions differ
        torch.backends.cudnn.deterministic = True
        runs = {}
        for run, lift_fn, comp_fn in (
                ("kernel", weighted_gather_sum, composite_tiles),
                ("plain", weighted_gather_sum_reference,
                 composite_tiles_reference)):
            lift, comp = Recorder(lift_fn), Recorder(comp_fn)
            with mock.patch.object(voxel_lift, "weighted_gather_sum", lift), \
                    mock.patch.object(splat_tiles, "composite_tiles", comp):
                runs[run] = (predict(scenes[0]), lift, comp)
        (pk, lk, ck), (pp, lp, _) = runs["kernel"], runs["plain"]
        check(lk.args[0].dtype == dtype,
              f"the lift gathered {lk.args[0].dtype} rows in a {label} model")
        vol_rel = rel_err(lk.out, lp.out)
        rend_err = float(np.abs(pk["rendered"] - pp["rendered"]).max())
        mask_equal = bool(np.array_equal(pk["mask"], pp["mask"]))
        m = pk["mask"]
        boxes_equal = mask_equal and bool(
            np.array_equal(pk["labels"][m], pp["labels"][m])
            and np.allclose(pk["boxes"][m], pp["boxes"][m], rtol=1e-5,
                            atol=1e-5))
        emit(phase=f"{phase}_vs_plain", dtype=label,
             volume_max_rel_err=vol_rel,
             rendered_max_abs_err=rend_err, mask_equal=mask_equal,
             boxes_labels_equal_under_mask=boxes_equal,
             kept_boxes=int(m.sum()))
        check(rend_err <= 1e-4, f"{phase} {label}: rendered differs by "
                                f"{rend_err} > 1e-4")
        check(vol_rel <= 1e-5, f"{phase} {label}: lifted volume differs by "
                               f"{vol_rel} > 1e-5")
        check(boxes_equal, f"{phase} {label}: kept boxes or labels differ "
                           f"under the mask")
        k1_args, k3_args = detached(ck.args), detached(lk.args)
        torch.backends.cudnn.deterministic = False
        del model, predict, preds, runs, pk, pp, lk, lp, ck
        torch.cuda.empty_cache()
        return launches, bf16_launches, k1_args, k3_args

    def train_phases(cfg, dtype, scene, grads32=None, phase="train"):
        """TRAIN_STEPS steps through fit with the launch counts set to 0
        just before and read just after, then one step's forward and
        backward with the kernels against one with the plain versions (and,
        given the float32 run's gradients, against those).  Returns the
        launches, the kernel run's recorders and its gradients (on the
        host)."""
        label = str(dtype).replace("torch.", "")
        state = create_train_state(
            cfg, device="cuda", dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed))
        params0 = {k: p.detach().clone()
                   for k, p in state.model.named_parameters()}
        step_logs = []
        t_start = [time.perf_counter()]

        def log_step(i, metrics):
            now = time.perf_counter()
            step_logs.append(dict(step=i, latency_ms=(now - t_start[0]) * 1e3,
                                  **metrics))
            t_start[0] = now
            emit(phase=phase, dtype=label, **step_logs[-1])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_start[0] = time.perf_counter()
        fit(state, (scene for _ in range(TRAIN_STEPS)), TRAIN_STEPS,
            log_every=1, log_fn=log_step)
        launches, bf16_launches = read_launches()
        steady = [s["latency_ms"] for s in step_logs[1:]]
        emit(phase=phase, dtype=label, steps=TRAIN_STEPS,
             views=cfg.data.n_src_train,
             targets=cfg.data.nerf_target_views_train, launches=launches,
             bf16_launches=bf16_launches,
             first_step_ms=step_logs[0]["latency_ms"],
             steady_step_ms=statistics.mean(steady),
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        check_launches(
            launches, bf16_launches, {name: TRAIN_STEPS for name in launches},
            {name: TRAIN_STEPS if dtype == bf16 else 0
             for name in bf16_launches},
            f"{TRAIN_STEPS} {label} {phase} steps")
        for log in step_logs:
            check(all(np.isfinite(v) for k, v in log.items()
                      if k not in ("step", "latency_ms")),
                  f"{phase} {label} step {log['step']}: a loss is not "
                  f"finite: {log}")
            check(log["loss_nvs"] > 0 and "cls_loss" in log,
                  f"{phase} {label} step {log['step']}: loss terms "
                  f"missing: {log}")
        moved = frozen_moved = 0
        for name, p in state.model.named_parameters():
            changed = not torch.equal(p.detach(), params0[name])
            if name.startswith(frozen_prefixes):
                frozen_moved += changed
            else:
                moved += changed
        state_dtypes = sorted({str(t.dtype) for t in (
            list(state.model.parameters()) + list(state.model.buffers())
            + [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.ndim])})
        emit(phase=phase, dtype=label, parameters_moved=moved,
             frozen_moved=frozen_moved, state_dtypes=state_dtypes)
        check(moved > 0.9 * sum(1 for n in params0
                                if not n.startswith(frozen_prefixes)),
              f"{phase} {label}: only {moved} trainable parameters moved")
        check(frozen_moved == 0, f"{phase} {label}: {frozen_moved} frozen "
                                 f"parameters moved")
        check(state_dtypes == ["torch.float32"],
              f"{phase} {label}: parameters, statistics or AdamW state in "
              f"{state_dtypes}")
        del state, params0

        # one step with the kernels, then with the plain versions; cuDNN
        # and the sweep's index_add_ deterministic, so that the two runs
        # differ only where the kernels and their plain versions do
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        base = create_train_state(
            cfg, device="cuda", dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed))
        batch = {k: torch.as_tensor(v).cuda() for k, v in scene.items()}
        recorders = {}
        results = {}
        for run in ("kernel", "plain"):
            model = copy.deepcopy(base.model)
            if run == "kernel":
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
            results[run] = ({k: v.item() for k, v in aux.items()},
                            {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None}, running_stats(model))
            del model, total, aux
        (lk_, gk, sk), (lp_, gp, sp) = results["kernel"], results["plain"]
        loss_rel = {k: abs(lk_[k] - lp_[k]) / max(abs(lp_[k]), 1e-30)
                    for k in lp_}
        check(set(gk) == set(gp), f"{phase} {label}: the two runs give "
                                  f"gradients to different parameters")
        def rel_by_leaf(a, b):
            return {k: (torch.linalg.vector_norm(a[k] - b[k])
                        / torch.linalg.vector_norm(b[k]).clamp_min(1e-30))
                    .item() for k in b}

        def rel_all(a, b):
            return math.sqrt(sum(float((a[k] - b[k]).square().sum())
                                 for k in b)
                             / sum(float(b[k].square().sum()) for k in b))

        grad_rel = rel_by_leaf(gk, gp)
        worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
        extra = {}
        if grads32 is not None:
            # the witness: how far this dtype's gradients are from the
            # float32 run's, same weights, same scene (kept on the host)
            gk_host = {k: v.cpu() for k, v in gk.items()}
            witness = rel_by_leaf(gk_host, grads32)
            extra = dict(all_grads_rel_err_from_float32=rel_all(gk_host,
                                                                grads32),
                         worst_grads_from_float32=sorted(
                             witness.items(), key=lambda kv: -kv[1])[:5])
        all_rel = rel_all(gk, gp)
        emit(phase=f"{phase}_vs_plain", dtype=label, loss_rel_err=loss_rel,
             max_grad_rel_err=worst[0][1], all_grads_rel_err=all_rel,
             worst_grads=worst, n_grads=len(grad_rel), **extra)
        check(max(loss_rel.values()) <= 1e-5,
              f"{phase} {label}: loss terms differ: {loss_rel}")
        # float32: the kernels and the plain versions sum in other orders.
        # bf16: K4 rounds each d-feat value once from its own float32 sum
        # and the plain backward from another, so now and then a value
        # differs by one bf16 ulp, and the bf16 backward of the FPN and
        # ResNet spreads those flips into every backbone gradient (7.9e-3
        # on the worst leaf at these inputs)
        leaf_tol, all_tol = (1e-4, 1e-4) if dtype == torch.float32 \
            else (2.5e-2, 1e-2)
        check(worst[0][1] <= leaf_tol and all_rel <= all_tol,
              f"{phase} {label}: gradients differ: {worst}, all {all_rel}")
        feat_dtype = recorders["weighted_gather_sum"][1].args[0].dtype
        dfeat_dtype = recorders["weighted_gather_sum_dfeat"][1].out.dtype
        check(feat_dtype == dfeat_dtype == dtype,
              f"{phase} {label}: the lift took {feat_dtype} rows and gave a "
              f"{dfeat_dtype} d-feat")
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        gk = {k: v.cpu() for k, v in gk.items()}
        del base, batch, results, gp
        torch.cuda.empty_cache()
        return launches, bf16_launches, recorders, gk, (sk, sp)

    def batch_norm_phases(scene):
        """CostRegNet trained in BatchNorm mode (`cost_reg_norm="batch"`):
        `train_phases` in float32, then the running statistics after its
        one step with the kernels against those with the plain versions,
        and against a fresh model's after the forward alone (BatchNorm
        must move them once a step, not again in backward)."""
        cfg_bn = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, cost_reg_norm="batch"))
        *_, (kernel, plain) = train_phases(cfg_bn, torch.float32, scene,
                                           phase="batch_norm_train")
        model = create_train_state(
            cfg_bn, device="cuda",
            generator=torch.Generator().manual_seed(cfg.seed)).model
        initial = running_stats(model)
        torch.backends.cudnn.deterministic = True
        model.loss({k: torch.as_tensor(v).cuda() for k, v in scene.items()})
        torch.backends.cudnn.deterministic = False
        forward = running_stats(model)
        cost_reg = [k for k in initial if k.startswith("cost_reg.")]

        def max_rel(a, b, keys):
            return max(((a[k] - b[k]).abs().max()
                        / b[k].abs().max().clamp_min(1e-30)).item()
                       for k in keys)

        vs_plain = max_rel(kernel, plain, initial)
        vs_forward = max_rel(kernel, forward, cost_reg)
        moved = sum(not torch.equal(kernel[k], initial[k]) for k in cost_reg)
        emit(phase="batch_norm_statistics", statistics=len(initial),
             cost_reg_statistics=len(cost_reg), cost_reg_moved=moved,
             max_rel_err_vs_plain=vs_plain,
             cost_reg_max_rel_err_vs_forward_only=vs_forward)
        check(len(cost_reg) == 14 and moved == len(cost_reg),
              f"batch norm: {moved} of {len(cost_reg)} CostRegNet running "
              f"statistics moved in a step")
        check(vs_plain <= 1e-6, f"batch norm: running statistics differ from "
                                f"the plain versions' step by {vs_plain}")
        check(vs_forward <= 1e-6,
              f"batch norm: backward moved CostRegNet's running statistics "
              f"again ({vs_forward} from the forward's)")
        del model
        torch.cuda.empty_cache()

    scenes = [make_synthetic_scene(cfg, seed=s, n_views=cfg.data.n_src_test,
                                   n_targets=cfg.data.nerf_target_views_test)
              for s in range(N_SCENES)]
    predict_launches, _, k1_predict_args, k3_predict_args = predict_phases(
        cfg, scenes, torch.float32)
    cull = cull_check(k1_predict_args[0], k1_predict_args[2])
    emit(phase="cull", tables="predict", tiles=k1_predict_args[0].shape[0],
         k=k1_predict_args[0].shape[2], **cull)
    check_cull(cull, "predict")
    _, predict_bf16_launches, _, k3b_predict_args = predict_phases(
        cfg, scenes, bf16)

    scene = make_synthetic_scene(cfg, seed=0, n_views=cfg.data.n_src_train,
                                 n_targets=cfg.data.nerf_target_views_train)
    train_launches, _, recorders, grads32, _ = train_phases(
        cfg, torch.float32, scene)
    _, train_bf16_launches, recorders_bf16, _, _ = train_phases(
        cfg, bf16, scene, grads32)

    # -- the ARKit configuration: per-view intrinsics, the yaw head -------
    arkit = arkit_config()
    scenes = [make_synthetic_scene(
        arkit, seed=s, n_views=arkit.data.n_src_test,
        n_targets=arkit.data.nerf_target_views_test, arkit=True)
        for s in range(N_SCENES)]
    arkit_launches, _, _, k3_arkit_args = predict_phases(
        arkit, scenes, torch.float32, phase="arkit_predict")
    _, arkit_bf16_launches, _, k3b_arkit_args = predict_phases(
        arkit, scenes, bf16, phase="arkit_predict")
    arkit_scene = make_synthetic_scene(
        arkit, seed=0, n_views=arkit.data.n_src_train,
        n_targets=arkit.data.nerf_target_views_train, arkit=True)
    _, _, _, grads32, _ = train_phases(arkit, torch.float32, arkit_scene,
                                       phase="arkit_train")
    train_phases(arkit, bf16, arkit_scene, grads32, phase="arkit_train")
    del scenes, arkit_scene, grads32

    batch_norm_phases(scene)

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
    k3_got = weighted_gather_sum(*k3_args)
    k3_ref = weighted_gather_sum_reference(*k3_args)
    k3_err = (k3_got - k3_ref).abs().max().item()
    k3_equal = torch.equal(k3_got, k3_ref)
    # K4 and K5 got the index the backward built: (..., rows)
    (pix4, w4, g4, hw4), rows4 = k4_args[:4], k4_args[4]
    (feat5, pix5, g5), rows5 = k5_args[:3], k5_args[3]
    k4_args, k5_args = k4_args[:4], k5_args[:3]
    index_err = max(int((a - b).abs().max()) for a, b in zip(
        rows4, lift_rows_reference(pix4, hw4)))
    k4_got = weighted_gather_sum_dfeat(*k4_args)
    k4_in_order = torch.equal(k4_got, weighted_gather_sum_dfeat_rows_reference(
        rows4, w4, g4, hw4))
    k4_ref = weighted_gather_sum_dfeat_reference(*k4_args)
    k4_err = (k4_got - k4_ref).abs().max().item()
    k5_ref = weighted_gather_sum_dweight_reference(*k5_args)
    k5_err = (weighted_gather_sum_dweight(*k5_args) - k5_ref).abs().max() \
        .item()
    cull = cull_check(k1_args[0], k1_args[2])
    emit(phase="cull", tables="train", tiles=k1_args[0].shape[0],
         k=k1_args[0].shape[2], **cull)
    check_cull(cull, "train")
    check(k1_err <= 1e-4, f"K1 on train inputs: {k1_err}")
    check(k2_err <= k2_tol, f"K2 on train inputs: {k2_err} > {k2_tol}")
    check(k3_equal, f"K3 on train inputs is not bit-equal to its plain "
                    f"version: {k3_err}")
    check(k4_err <= 1e-5 * k4_ref.abs().max().item(),
          f"K4 on train inputs: {k4_err}")
    check(k5_err <= 1e-5 * k5_ref.abs().max().item(),
          f"K5 on train inputs: {k5_err}")
    check(index_err == 0, f"the step's row index differs from "
                          f"lift_rows_reference by {index_err}")
    check(rows5 is rows4, "K4 and K5 got two indexes in one backward")
    check(k4_in_order, "K4 on train inputs differs from its plain version "
                       "in its own order")
    del k1_ref, k2_got, k2_ref, k3_got, k3_ref, k4_got, k4_ref, k5_ref

    feat3, pix3, w3 = k3_args
    lib_bwd_ms = cuda_ms(embedding_bag_backward_fn(feat3, pix3, w3, g4))
    index_ms = cuda_ms(lambda: lift_rows(pix4, hw4))
    backward_ms = cuda_ms(lift_backward_fn(weighted_gather_sum, feat5, pix4,
                                           w4, g4), reps=BACKWARD_REPS)
    keys4 = (torch.arange(pix4.shape[0], device="cuda")[:, None] * hw4
             + pix4.long()).flatten()
    index_b, index_by = index_bound(pix4, hw4)
    k1_b, k1_by = k1_bound(k1_args[0], k1_args[1], cull)
    k2_b, k2_by = k2_bound(k2_args[0], k2_args[1], cull)
    k1_all, _ = k1_bound(k1_args[0], k1_args[1], cull, all_pairs=True)
    k2_all, _ = k2_bound(k2_args[0], k2_args[1], cull, all_pairs=True)
    k3_b, k3_by = k3_bound(*k3_args)
    k4_b, k4_by = k4_bound(pix4, w4, g4, hw4)
    k5_b, k5_by = k5_bound(feat5, pix5, g5)
    lift_shape = dict(n=feat5.shape[0], hw=feat5.shape[1], c=feat5.shape[2],
                      v=pix5.shape[1], nonzero_weights=int((w4 != 0).sum()),
                      selected_rows=selected_rows(pix5, hw4))
    kernels = [
        dict(name="composite_tiles", route="cuda",
             source="mvsdet_torch/ops/csrc/composite_tiles.cu",
             replaces="mvsdet_tpu/ops/pallas/splat_kernel.py:48",
             launches=train_launches["composite_tiles"],
             predict_launches=predict_launches["composite_tiles"],
             max_abs_err=k1_err,
             ms=cuda_ms(lambda: composite_tiles(*k1_args)),
             host_paced_ms=cuda_ms(lambda: composite_tiles(*k1_args),
                                   queued=False),
             predict_ms=cuda_ms(lambda: composite_tiles(*k1_predict_args)),
             predict_host_paced_ms=cuda_ms(
                 lambda: composite_tiles(*k1_predict_args), queued=False),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(*k1_args),
                              reps=3),
             bound_ms=k1_b, bound_by=k1_by, all_pairs_bound_ms=k1_all,
             library_ms=None,
             shape=dict(tiles=k1_args[0].shape[0], k=k1_args[0].shape[2],
                        c=k1_args[1].shape[1])),
        dict(name="composite_tiles_bwd", route="cuda",
             source="mvsdet_torch/ops/csrc/composite_tiles_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/splat_kernel.py:126",
             launches=train_launches["composite_tiles_bwd"],
             max_abs_err=k2_err,
             ms=cuda_ms(lambda: composite_tiles_bwd(*k2_args)),
             host_paced_ms=cuda_ms(lambda: composite_tiles_bwd(*k2_args),
                                   queued=False),
             plain_ms=cuda_ms(lambda: composite_tiles_bwd_reference(
                 *k2_args), reps=3),
             bound_ms=k2_b, bound_by=k2_by, all_pairs_bound_ms=k2_all,
             library_ms=None,
             shape=dict(tiles=k2_args[0].shape[0], k=k2_args[0].shape[2],
                        c=k2_args[1].shape[1])),
        dict(name="weighted_gather_sum", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:41",
             launches=train_launches["weighted_gather_sum"],
             predict_launches=predict_launches["weighted_gather_sum"],
             max_abs_err=k3_err,
             ms=cuda_ms(lambda: weighted_gather_sum(*k3_args)),
             host_paced_ms=cuda_ms(lambda: weighted_gather_sum(*k3_args),
                                   queued=False),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
                 *k3_args), reps=3),
             bound_ms=k3_b, bound_by=k3_by,
             library_ms=cuda_ms(embedding_bag_fn(*k3_args)),
             shape=dict(n=feat3.shape[0], hw=feat3.shape[1], c=feat3.shape[2],
                        v=pix3.shape[1],
                        nonzero_weights=int((w3 != 0).sum()),
                        selected_rows=selected_rows(pix3, feat3.shape[1],
                                                    w3 != 0))),
        dict(name="weighted_gather_sum_dfeat", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:62",
             launches=train_launches["weighted_gather_sum_dfeat"],
             max_abs_err=k4_err,
             ms=cuda_ms(lambda: weighted_gather_sum_dfeat(*k4_args)),
             host_paced_ms=cuda_ms(
                 lambda: weighted_gather_sum_dfeat(*k4_args), queued=False),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_dfeat_reference(
                 *k4_args), reps=3),
             bound_ms=k4_b, bound_by=k4_by, library_ms=lib_bwd_ms,
             library_covers="K4+K5: one autograd.grad of embedding_bag",
             index_ms=index_ms, backward_ms=backward_ms,
             equals_rows_reference=k4_in_order, shape=lift_shape),
        dict(name="weighted_gather_sum_dweight", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:82",
             launches=train_launches["weighted_gather_sum_dweight"],
             max_abs_err=k5_err,
             ms=cuda_ms(lambda: weighted_gather_sum_dweight(*k5_args)),
             host_paced_ms=cuda_ms(
                 lambda: weighted_gather_sum_dweight(*k5_args), queued=False),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_dweight_reference(
                 *k5_args), reps=3),
             bound_ms=k5_b, bound_by=k5_by, library_ms=lib_bwd_ms,
             library_covers="K4+K5: one autograd.grad of embedding_bag",
             index_ms=index_ms, backward_ms=backward_ms,
             feature_row_loads=k5_row_loads(weighted_gather_sum_dweight,
                                            *k5_args, rows5),
             pairs=pix5.numel(), shape=lift_shape),
        dict(name="lift_rows", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:62 and :82 (the "
                      "one-hot of pix that _dfeat_kernel and _dweight_kernel "
                      "build)",
             launches=train_launches["lift_rows"],
             max_abs_err=float(index_err),
             ms=index_ms,
             host_paced_ms=cuda_ms(lambda: lift_rows(pix4, hw4),
                                   queued=False),
             plain_ms=cuda_ms(lambda: lift_rows_reference(pix4, hw4),
                              reps=3),
             bound_ms=index_b, bound_by=index_by,
             library_ms=cuda_ms(lambda: torch.sort(keys4, stable=True)),
             library_covers="pair only: one stable torch.sort of the flat "
                            "row keys",
             shape=lift_shape),
    ]

    # the bf16 variants, on the inputs the bf16 step gave them
    bf16 = torch.bfloat16
    args16 = {name: detached(r.args) for name, (_, r) in recorders_bf16.items()}
    k3b_args = args16["weighted_gather_sum"]
    (pix4b, w4b, g4b, hw4b), rows4b = (args16["weighted_gather_sum_dfeat"][:4],
                                       args16["weighted_gather_sum_dfeat"][4])
    k4b_args = (pix4b, w4b, g4b, hw4b, None, bf16)
    k5b_args = args16["weighted_gather_sum_dweight"][:3]
    feat3b, pix3b, w3b = k3b_args
    feat5b = k5b_args[0]
    check(feat3b.dtype == feat5b.dtype == bf16,
          "the bf16 step's lift took other than bf16 rows")
    k3b_got = weighted_gather_sum(*k3b_args)
    k3b_ref = weighted_gather_sum_reference(*k3b_args)
    k3b_err = (k3b_got - k3b_ref).abs().max().item()
    k3b_equal = torch.equal(k3b_got, k3b_ref) and torch.equal(
        k3b_got, weighted_gather_sum(feat3b.float(), pix3b, w3b))
    k4b_got = weighted_gather_sum_dfeat(*k4b_args)
    k4b_in_order = torch.equal(
        k4b_got, weighted_gather_sum_dfeat_rows_reference(rows4b, w4b, g4b,
                                                          hw4b, bf16))
    k4b_ref = weighted_gather_sum_dfeat_reference(pix4b, w4b, g4b, hw4b)
    k4b_err = (k4b_got.float() - k4b_ref).abs().max().item()
    k4b_share = bf16_rounding_share(k4b_got, k4b_ref)
    k5b_ref = weighted_gather_sum_dweight_reference(*k5b_args)
    k5b_err = (weighted_gather_sum_dweight(*k5b_args) - k5b_ref).abs().max() \
        .item()
    check(k3b_equal, f"bf16 K3 on train inputs is not bit-equal to its "
                     f"plain version and to the float32 kernel on the "
                     f"widened rows: {k3b_err}")
    check(k4b_in_order, "bf16 K4 on train inputs differs from its plain "
                        "version in its own order")
    check(k4b_share <= 1, f"bf16 K4 on train inputs is {k4b_share} bf16 "
                          f"ulps from its float32 plain version")
    check(k5b_err <= 1e-5 * k5b_ref.abs().max().item(),
          f"bf16 K5 on train inputs: {k5b_err}")
    del k3b_got, k3b_ref, k4b_got, k4b_ref, k5b_ref
    backward_b_ms = cuda_ms(lift_backward_fn(weighted_gather_sum, feat5b,
                                             pix4b, w4b, g4b),
                            reps=BACKWARD_REPS)
    k3b_b, k3b_by = k3_bound(*k3b_args)
    k4b_b, k4b_by = k4_bound(pix4b, w4b, g4b, hw4b, out_bytes=2)
    k5b_b, k5b_by = k5_bound(*k5b_args)
    lift_shape_b = dict(lift_shape, nonzero_weights=int((w4b != 0).sum()),
                        selected_rows=selected_rows(k5b_args[1], hw4b))
    kernels += [
        dict(name="weighted_gather_sum_bf16", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:41",
             launches=train_bf16_launches["weighted_gather_sum"],
             predict_launches=predict_bf16_launches["weighted_gather_sum"],
             max_abs_err=k3b_err,
             ms=cuda_ms(lambda: weighted_gather_sum(*k3b_args)),
             host_paced_ms=cuda_ms(lambda: weighted_gather_sum(*k3b_args),
                                   queued=False),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
                 *k3b_args), reps=3),
             bound_ms=k3b_b, bound_by=k3b_by,
             library_ms=cuda_ms(embedding_bag_fn(*k3b_args)),
             library_covers="embedding_bag of bf16 rows with bf16 weights, "
                            "summed into bf16",
             shape=dict(n=feat3b.shape[0], hw=feat3b.shape[1],
                        c=feat3b.shape[2], v=pix3b.shape[1],
                        nonzero_weights=int((w3b != 0).sum()),
                        selected_rows=selected_rows(pix3b, feat3b.shape[1],
                                                    w3b != 0))),
        dict(name="weighted_gather_sum_dfeat_bf16", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:62",
             launches=train_bf16_launches["weighted_gather_sum_dfeat"],
             max_abs_err=k4b_err, rounding_share=k4b_share,
             ms=cuda_ms(lambda: weighted_gather_sum_dfeat(*k4b_args)),
             host_paced_ms=cuda_ms(
                 lambda: weighted_gather_sum_dfeat(*k4b_args), queued=False),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_dfeat_reference(
                 pix4b, w4b, g4b, hw4b, bf16), reps=3),
             bound_ms=k4b_b, bound_by=k4b_by, library_ms=None,
             library_covers="none: embedding_bag has no bf16 backward for "
                            "per-sample weights on CUDA",
             backward_ms=backward_b_ms, equals_rows_reference=k4b_in_order,
             shape=lift_shape_b),
        dict(name="weighted_gather_sum_dweight_bf16", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum_bwd.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:82",
             launches=train_bf16_launches["weighted_gather_sum_dweight"],
             max_abs_err=k5b_err,
             ms=cuda_ms(lambda: weighted_gather_sum_dweight(*k5b_args)),
             host_paced_ms=cuda_ms(
                 lambda: weighted_gather_sum_dweight(*k5b_args), queued=False),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_dweight_reference(
                 *k5b_args), reps=3),
             bound_ms=k5b_b, bound_by=k5b_by, library_ms=None,
             library_covers="none: embedding_bag has no bf16 backward for "
                            "per-sample weights on CUDA",
             backward_ms=backward_b_ms,
             feature_row_loads=k5_row_loads(weighted_gather_sum_dweight,
                                            *k5b_args, rows4b),
             pairs=k5b_args[1].numel(), shape=lift_shape_b),
    ]
    # K3 at the predicts' own inputs (80 views; ARKit: 100), float32 and
    # bf16
    for name, launches, args in (
            ("weighted_gather_sum_predict",
             predict_launches["weighted_gather_sum"], k3_predict_args),
            ("weighted_gather_sum_bf16_predict",
             predict_bf16_launches["weighted_gather_sum"], k3b_predict_args),
            ("weighted_gather_sum_arkit_predict",
             arkit_launches["weighted_gather_sum"], k3_arkit_args),
            ("weighted_gather_sum_bf16_arkit_predict",
             arkit_bf16_launches["weighted_gather_sum"], k3b_arkit_args)):
        feat_p, pix_p, w_p = args
        got = weighted_gather_sum(*args)
        ref = weighted_gather_sum_reference(*args)
        err = (got - ref).abs().max().item()
        equal = torch.equal(got, ref) and torch.equal(
            got, weighted_gather_sum(feat_p.float(), pix_p, w_p))
        check(equal, f"{name}: not bit-equal to its plain version and to the "
                     f"float32 kernel on the widened rows: {err}")
        del got, ref
        b, by = k3_bound(*args)
        nz = w_p != 0
        kernels.append(dict(
            name=name, route="cuda",
            source="mvsdet_torch/ops/csrc/weighted_gather_sum.cu",
            replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:41",
            launches=launches, max_abs_err=err,
            ms=cuda_ms(lambda: weighted_gather_sum(*args)),
            host_paced_ms=cuda_ms(lambda: weighted_gather_sum(*args),
                                  queued=False),
            plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(*args),
                             reps=3),
            bound_ms=b, bound_by=by,
            library_ms=cuda_ms(embedding_bag_fn(*args)),
            shape=dict(n=feat_p.shape[0], hw=feat_p.shape[1],
                       c=feat_p.shape[2], v=pix_p.shape[1],
                       dtype=str(feat_p.dtype).replace("torch.", ""),
                       nonzero_weights=int(nz.sum()),
                       selected_rows=selected_rows(pix_p, feat_p.shape[1],
                                                   nz))))
    if opts.save_kernel_inputs:
        torch.save({"k1": k1_args, "k2": k2_args,
                    "k1_predict": k1_predict_args, "k3": k3_args,
                    "k3_predict": k3_predict_args, "k4": k4_args,
                    "k5": k5_args, "k3_bf16": k3b_args,
                    "k3_bf16_predict": k3b_predict_args, "k4_bf16": k4b_args,
                    "k5_bf16": k5b_args}, opts.save_kernel_inputs)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
