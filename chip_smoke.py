#!/usr/bin/env python3
"""Drive the port's predict path (with and without its diagnostics) and
training step on one NVIDIA card, in the ScanNet and the ARKit
configurations, alone and sharded over rank processes, the legacy
NeRF-Det's training and evaluation, and the learning check, and check
them.

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
  K1_c1    the compositor with one channel (the predict's rendered depth)
           on random tables at the predict's shape (T=80, K=2048, C=1, 30%
           empty slots): max abs error <= 1e-4, and a second launch
           bit-equal to the first
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
  diagnostics
           the same three scenes through `make_predict_fn(...,
           diagnostics=True)`, launch counts set to 0 just before and read
           just after (K1 twice a scene, once with one channel for the
           rendered depth, K3 once, the backward kernels never);
           rendered_depth (1, 120, 160) finite and at most the far plane
           + 1, weight_gap in [0, 1], src_rmse finite, the flat Gaussians
           finite; the steady predict time without and with the
           diagnostics; then `diagnostics_vs_plain`, the first scene with
           the plain versions: rendered_depth within 1e-4 of max |plain|,
           weight_gap and src_rmse within 1e-5 relative, the Gaussians
           within 1e-5.  Float32, then bf16
  dense_vs_tiled
           the Gaussians the model predicts from 8 source views (G =
           38,400) rendered into the 120x160 target by the dense exact
           renderer (`ops/splat.py` `render_view`), colour and depth,
           against `render_view_tiled` with every Gaussian binned into
           every tile (K1 then sees every pair the dense renderer sees):
           within 1e-3 max abs; the dense renderer's time and peak memory,
           and those of one forward and backward of its colour render
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
  sweep_paths
           the port's counterpart of `scripts/compare_sweep_paths.py`, at
           the step's inputs: the features of the 40-view scene from the
           seeded ResNet-50 + FPN (60x80, C=256), D=12, k=2.  Every view
           swept by the default two-product shear warp
           (`sweep_method="mxu"`, the sweep of every other phase) and by
           the bilinear gather with the same CostRegNet, in float32 and
           in bf16: top-1 plane agreement, the probabilities'
           correlation, the top-k depth sets matching to a tenth of the
           plane interval, the depth expectation's RMSE and maximum
           difference.  The card's mxu sweep against the port's on the
           CPU on 2 reference views: from the same homographies the warp
           within 1e-5 of max |CPU| in float32, within its witness (the
           card's bf16 against its float32) in bf16; each device from its
           own inverse and homographies, the warped neighbours and the
           variance within twice their witness, the CPU's sweep from
           projections one float32 ulp away.  Times of one sweep chunk
           (8 references) forward and forward + backward for each sweep
           and dtype, and the steady
           80-view predict (3 scenes) and 3-step training step with each
           sweep in each dtype, and the float32 step with CostRegNet in
           BatchNorm mode, with their peak memory
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
  launch_train
           the train launcher (`mvsdet_torch.tools.train.main`) in
           process: 4 bf16 steps on 2 synthetic scenes of 40 source views
           and 2 targets, an epoch of 2 steps, each epoch ending in a save
           of `latest`, an evaluation of one 80-view scene and a save of
           `best` where its mAP_0.25 is the best, into build/launch; four
           finite step records and two evaluations in train_log.jsonl,
           both checkpoints written, launch counts set to 0 just before
           and read just after (K1-K5 and the index 4 each, plus K1 and K3
           once per evaluated scene); the first and steady step times, the
           evaluations' predict times and the saves' times
  launch_test
           the test launcher in process from that `best` checkpoint on 3
           synthetic 80-view scenes in float32: the weights it loaded are
           the trained ones (a head parameter equal to `best`'s and unlike
           the untrained one), the metric dict has mAP_0.25, mAP_0.50,
           psnr, ssim, predict_s_first and predict_s_per_scene, K1 and K3
           launched once per scene; again with `--diagnostics --vis-dir
           build/vis`: finite depth_rmse, weight_gap and src_rmse, each
           scene's PNGs and a PLY of more than 0 vertices, K1 twice and
           K3 once a scene, the hook's seconds per scene; then the same
           evaluation without and with `--diagnostics`, each with the
           kernels and with the plain versions, cuDNN deterministic
           (`launch_test_vs_plain`), from a copy of `best` whose head is
           fitted in closed form to the scenes' spheres on its own neck
           features (`detecting_head`): mAP_0.25 above 0, the boxes,
           scores and labels the mAP is given equal (boxes and scores to
           1e-5), every AP equal, psnr and ssim (and depth_rmse) within
           1e-4 relative, weight_gap and src_rmse within 1e-5; then
           `--arkit` on 2 scenes in bf16: 7-dim boxes reach the mAP, the
           same keys, K1 and K3 (bf16) once per scene
  parallel_train
           data x view parallelism with rank processes sharing the card
           (spawned from this script, a file store under build/parallel;
           gloo, as `multihost.backend_for` picks it for ranks sharing a
           card; every line names its backend): one float32 step of
           `scannet_config()` from the seeded weights, cuDNN
           deterministic, through `fit` with a 1 x 2 and a 2 x 1 mesh, on
           40-view scenes with 2 targets (3 steps each; the first step's
           averaged gradients compared, the last one's collectives timed
           between device synchronisations, so the second is the step
           time).  data 2: losses <= 1e-5 and every gradient <= 1e-4
           relative against the mean of the two scenes' unsharded steps
           with the head's positive count set to their mean.  view 2:
           losses <= 1e-5 against the unsharded step batched as the ranks
           batch (the backbone on each half of the views, CostRegNet on
           the ranks' sweep chunks, the lift summed as two halves; the
           plain unsharded step's distance is reported beside it), and
           the largest leaf's and all the gradients' distance from it at
           most twice the witness's, the plain unsharded step against
           the same with the lift summed as two halves (a change of
           summation order alone).  Per rank: K1-K5 and the index once a step, the step
           times, the peak memory, every collective's calls, MB and ms,
           and every rank's parameters equal after the steps
  parallel_train_bf16
           data 2 x view 2 in bf16 on 4 ranks, 2 steps: losses finite,
           90% of the trainable parameters moved, all 4 ranks'
           parameters bit-equal, K3-K5 as their bf16 variants; step times
           and peak memory per rank
  parallel_nccl
           world size 1 on NCCL (one rank, its own card): one step through
           `make_sharded_train_step` bit-equal to `train_step`'s (every
           parameter, statistic and loss term)
  parallel_predict
           the test launcher's `evaluate` with `--data-parallel 2` on 2
           ranks from `launch_test`'s fitted checkpoint on its 3 scenes
           (80 views; the last group padded), without and then with
           `--diagnostics` in the same ranks: the APs equal, psnr and
           ssim within 1e-4 (depth_rmse, weight_gap and src_rmse within
           1e-5), the boxes, scores and labels given to the mAP equal
           (1e-5) to `launch_test_vs_plain`'s kernel run one scene at a
           time; on each rank K1 and K3 twice, and under the diagnostics
           K1 twice more with one channel
  launch_train_parallel
           `python -m torch.distributed.run --standalone --nproc_per_node
           2 chip_smoke.py --launch-rank DIR` with the train launcher's
           `--synthetic 2 --steps 2 --data-parallel 2 --dtype bfloat16`:
           each torchrun process runs `mvsdet_torch.tools.train.main`;
           exit 0, the log's layout record (gloo, world 2), two finite
           step records from rank 0, `latest` written, both ranks'
           launches (2 each) and equal parameters
  cull     the compositor kernels' own cull boxes (`cull_boxes`) on the
           tables the predict and the training step gave K1, taken through
           the recorders: the slots `cull_boxes_reference` keeps, boxes
           within 1e-3 px of its boxes, no active pair outside its slot's
           box; and the work the cull leaves (pairs in a box, listed
           (warp patch, slot) pairs, per-CTA load)
  nerfdet_train
           the legacy NeRF-Det (`create_nerfdet_state(scannet_config())`,
           seeded random weights; float32, then computing in bf16, as
           every NeRF-Det phase, `dtype` in each line) for 3 steps of the
           40-view,
           2-target scene through `fit`, 2048 rays of 64 samples a step,
           launch counts set to 0 just before and read just after (none
           of K1-K5 or the index may launch: NeRF-Det's lift is a
           nearest-pixel gather); each step's loss terms and latency, the
           first and steady step times and the peak memory; losses
           finite, `loss_nvs` above 0, 90% of the trainable parameters
           moved, parameters, statistics and AdamW state float32
  nerfdet_vs_cpu
           the same model on an 8-view scene with 2 targets and fixed
           rays: one loss and gradient on the card (cuDNN deterministic,
           deterministic algorithms) against the same on the CPU: loss
           terms <= 1e-4 relative, and the largest leaf's and all the
           gradients' distance at most twice the witness's, the CPU step
           with the source views reversed and every parameter one ulp up
           (a change of summation order and of the weights' last bits);
           then one AdamW update of the card's weights, and a predict of
           them on the card and on the CPU (score_thr 0: random weights
           score every box under 0.01): the kept boxes and labels equal
           under the mask.  In bf16 the witness is the CPU step computing
           in float32, the loss terms are held together (the relative
           distance of their vector) to twice the witness's, the predicts
           must keep boxes, finite, and the predict's head outputs (each
           of center, bbox, cls over the levels) lie within twice their
           witness, the CPU's float32 predict of the same weights, from
           the CPU's (the share of the card's kept boxes that the CPU
           keeps too is reported: bf16 scores tie, and the two round them
           apart).  In both dtypes the card's step computes in its dtype
           where JAX does (the images into the backbone, alpha, the
           neck's input, the rendered colour) and renders the depth in
           float32
  launch_train_nerfdet
           the train launcher in process as `python -m
           mvsdet_torch.tools.train --model nerfdet --synthetic 2 --steps
           4 --val-synthetic 1` (into build/launch_nerfdet_<dtype>): four
           finite step records with `loss_nvs` above 0, an evaluation of one
           80-view scene after each epoch of 2 steps, `latest` and `best`
           written, no kernel launched; the step, evaluation and save
           times (`--dtype bfloat16` in the bf16 pass)
  overfit_map
           the learning check (`mvsdet_torch/tools/overfit_map.py`, JAX's
           scripts/overfit_map.py): 2 synthetic scenes overfit at the
           JAX learning tests' steps and evaluation cadence, mAP evaluated
           on them; the aligned head in float32 and bf16 (150 steps), the
           ARKit yaw head in bf16 (200), NeRF-Det in float32 and bf16
           (300), each over seeds 0, 1 and 2 from the weights the JAX
           package draws from each seed, with deterministic algorithms
           (15 runs in 5 processes sharing the card), and MVSDet's three
           cases again with the card's default kernels, as users train
           (9 runs in 3 more processes).  Each seed's history on a line
           of its own.  Gate, on the deterministic runs: every seed
           starts below mAP_0.25 0.3 and ends within 0.2 of its own best;
           per case, the median of the final mAP_0.25 and of the final
           mAR_0.25 over the seeds above JAX's gate (0.6 and 0.6; NeRF-Det
           0.4 and 0.5); the default-mode runs' verdict on the same gate
           is reported beside it.  In both modes each MVSDet training
           step launches K1-K5 and the index once (K3-K5 as their bf16
           variants in bf16), each evaluation K1 and K3 once a scene,
           NeRF-Det none, and the head computes in the case's dtype
  kernels  every kernel (K1-K5 and the lift backward's row index,
           `lift_rows`) with its launches in the train run (and, for K1
           and K3, in the predict run), its error, its time queued behind
           a device wait (`ms`) and host-paced as before the wait was added
           (`host_paced_ms`), its plain version's time, its bound and the
           time of one PyTorch call computing the same function, at the
           inputs the train step gave it; K1's time on the predict's
           tables; K1 with one channel (`composite_tiles_c1`) on the
           tables the float32 diagnostics predict gave it, with its
           one-channel launches there; for K1 and K2 also the bound that charges the cull test
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
and the script exits non-zero without that line; a failed `overfit_map`
gate raises after the kernels line, so that every other phase still
reports.  TF32 is off throughout
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
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
N_SCENES = 3
TRAIN_STEPS = 3
LAUNCH_STEPS = 4
# ~5 ms of device time at the H100's 1.98 GHz boost clock: more than the
# host takes to enqueue one trial of `cuda_ms`
QUEUE_AHEAD_CYCLES = 10_000_000
# autograd's host cost per backward is ~0.2 ms: 8 of them queue behind the
# wait, 20 would not
BACKWARD_REPS = 8
SOURCES = ("composite_tiles", "composite_tiles_bwd", "weighted_gather_sum",
           "weighted_gather_sum_bwd")
# the metrics a diagnostics evaluation adds (`evaluate_scenes`)
DIAGNOSTICS_METRICS = ("depth_rmse", "weight_gap", "src_rmse")
# the Gaussians of the dense renderer's check: 8 source views' worth
DENSE_SOURCE_VIEWS = 8


T0 = time.perf_counter()


def emit(**fields):
    """One phase line, with the seconds since the script started (`t`)."""
    print(json.dumps({**fields, "t": round(time.perf_counter() - T0, 1)}),
          flush=True)


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


def detecting_head(model, cfg):
    """``model``'s state with a head fitted, in closed form, to find the
    test launcher's synthetic spheres (seeds 1000 + s) from its own neck
    features: briefly trained or random weights give an mAP of 0, which a
    fault upstream of the head would give too.  Each head conv becomes a
    ridge least-squares map from a voxel's 3x3x3 window of features, the
    positives (the level-0 voxels within half a voxel of a sphere's
    centre) weighted 100: conv_cls's to the one-hot class of that sphere
    (zeros elsewhere), scaled so that a fit of 1 is a logit of 10 and one
    of 0 a logit of -10 (below `score_thr`); conv_reg's to the log of that
    sphere's radius (of the mean radius elsewhere), with unit scales, so
    each face distance is exp of the fit; conv_center zero (centerness
    0.5).

    Returns (state, fit): ``fit`` says how well the positives were fitted.
    """
    from mvsdet_torch.data.synthetic import make_synthetic_scene

    device = next(model.parameters()).device

    def taps(x):
        """(1, C, X, Y, Z) -> (XYZ, 27 C): each voxel's 3x3x3 window, in
        the order of a 3x3x3 conv kernel's taps, zero-padded as the head's
        convs pad."""
        size = x.shape[2:]
        xp = torch.nn.functional.pad(x[0].double(), (1, 1, 1, 1, 1, 1))
        return torch.cat([
            xp[:, i:i + size[0], j:j + size[1], k:k + size[2]].flatten(1)
            for i in range(3) for j in range(3) for k in range(3)]).T

    n_cls = cfg.model.head.n_classes
    half = np.asarray(cfg.model.voxel_size) / 2 + 1e-6
    feats, cls_t, reg_t, pos = [], [], [], []
    for s in range(N_SCENES):
        scene = make_synthetic_scene(
            cfg, seed=1000 + s, n_views=cfg.data.n_src_test,
            n_targets=cfg.data.nerf_target_views_test)
        with torch.inference_mode():
            out = model({k: torch.as_tensor(v, device=device)
                         for k, v in scene.items()})
        gt = scene["gt_boxes"][scene["gt_mask"]]
        labels = scene["gt_labels"][scene["gt_mask"]]
        radii = gt[:, 3:6].mean(axis=1) / 2
        for level, (x, pts) in enumerate(zip(out["levels"], out["points"])):
            feats.append(taps(x))                              # (V, 27 C)
            near = np.zeros((pts.shape[0], len(gt)), bool)
            if level == 0:
                near = np.all(np.abs(pts.cpu().numpy()[:, None]
                                     - gt[None, :, :3]) <= half, axis=-1)
            hit = near.any(axis=1)
            first = near.argmax(axis=1)
            onehot = np.zeros((len(hit), n_cls))
            onehot[hit, labels[first[hit]]] = 1.0
            cls_t.append(onehot)
            reg_t.append(np.where(hit, np.log(radii[first]), np.nan))
            pos.append(hit)
    x = torch.cat(feats)
    pos = torch.as_tensor(np.concatenate(pos), device=device)
    reg_t = np.concatenate(reg_t)
    mean_log_r = float(np.log(np.mean(np.exp(reg_t[~np.isnan(reg_t)]))))
    reg_t = torch.as_tensor(np.nan_to_num(reg_t, nan=mean_log_r),
                            device=device)
    cls_t = torch.as_tensor(np.concatenate(cls_t), device=device)

    def ridge(a, b, row_weight=None):
        if row_weight is not None:
            a, b = a * row_weight[:, None], b * row_weight[:, None]
        gram = a.T @ a
        gram += 1e-6 * gram.diagonal().mean() * torch.eye(
            gram.shape[0], dtype=gram.dtype, device=device)
        return torch.linalg.solve(gram, a.T @ b)

    xb = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    weight = torch.where(pos, 10.0, 1.0).double()
    w_cls = ridge(xb, cls_t, weight)                      # (27 C + 1, n)
    w_reg = ridge(x, reg_t[:, None], weight)              # (27 C, 1)
    cls_fit = (xb @ w_cls).amax(dim=1)
    reg_fit = (x @ w_reg)[:, 0]

    state = {k: v.clone() for k, v in model.state_dict().items()}

    def kernel(w, n_out):
        """(27 C, n) taps -> an (n_out, C, 3, 3, 3) conv kernel."""
        return w.T.reshape(-1, 27, w.shape[0] // 27).permute(0, 2, 1) \
            .reshape(-1, w.shape[0] // 27, 3, 3, 3).expand(n_out, -1, -1,
                                                           -1, -1).float()

    state["head.conv_center.weight"].zero_()
    state["head.conv_cls.weight"][:] = kernel(20.0 * w_cls[:-1], n_cls)
    state["head.conv_cls.bias"][:] = (20.0 * (w_cls[-1] - 0.5)).float()
    state["head.conv_reg.weight"][:] = kernel(
        w_reg, state["head.conv_reg.weight"].shape[0])
    state["head.scales"].fill_(1.0)
    fit = dict(positives=int(pos.sum()),
               cls_fit_positive_min=float(cls_fit[pos].min()),
               cls_fit_negative_max=float(cls_fit[~pos].max()),
               negatives_above_half=int((cls_fit[~pos] > 0.5).sum()),
               reg_fit_positive_abs_err=float(
                   (reg_fit - reg_t)[pos].abs().max()))
    return state, fit


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
    keeps the first call's inputs and output (the first whose inputs
    ``keep`` accepts, where it is given).  A wrapper counts its own
    launches through its module's name for it, which then names the
    Recorder, so `launches` and `bf16_launches` pass through to the
    wrapper."""

    def __init__(self, fn, keep=None):
        self.fn = fn
        self.keep = keep
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
        if self.args is None and (self.keep is None or self.keep(args)):
            self.args, self.out = args, out
        return out


def running_stats(model) -> dict:
    """Copies of a model's BatchNorm running means and variances."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def detached(args):
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


# -- the parallel phases: rank processes on the one card -----------------------

PARALLEL_SCENE_SEEDS = (0, 1)        # data row d trains on scene d


class CollectiveLog:
    """Wraps `torch.distributed.all_reduce` and `all_gather` in a rank
    process: while `on`, each call is timed on the host clock between two
    device synchronisations and kept with its caller, its shape and the
    bytes it moves (the tensor's, or the gathered output's)."""

    def __init__(self):
        self.on = False
        self.calls = []

    def install(self):
        for name in ("all_reduce", "all_gather"):
            setattr(dist, name, self._timed(name, getattr(dist, name)))

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            caller = sys._getframe(1).f_code.co_qualname
            t = args[0] if name == "all_reduce" else args[1]
            n = len(args[0]) if name == "all_gather" else 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append(dict(
                op=name, caller=caller, shape=list(t.shape),
                mb=n * t.numel() * t.element_size() / 1e6,
                ms=(time.perf_counter() - t0) * 1e3))
            return out
        return call

    def summary(self):
        """The calls by (op, caller): count, MB and ms in all."""
        out = {}
        for c in self.calls:
            s = out.setdefault(f"{c['op']} {c['caller']}",
                               dict(calls=0, mb=0.0, ms=0.0))
            s["calls"] += 1
            s["mb"] += c["mb"]
            s["ms"] += c["ms"]
        return out


def _launch_counts():
    from mvsdet_torch.ops import lift_kernel, splat_kernel
    fns = {"composite_tiles": splat_kernel.composite_tiles,
           "composite_tiles_bwd": splat_kernel.composite_tiles_bwd,
           "weighted_gather_sum": lift_kernel.weighted_gather_sum,
           "weighted_gather_sum_dfeat": lift_kernel.weighted_gather_sum_dfeat,
           "weighted_gather_sum_dweight":
               lift_kernel.weighted_gather_sum_dweight,
           "lift_rows": lift_kernel.lift_rows}
    return fns


def _reset_launches(fns):
    fns["composite_tiles"].c1_launches = 0
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0


def _read_launches(fns):
    return ({k: fn.launches for k, fn in fns.items()},
            {k: fn.bf16_launches for k, fn in fns.items()
             if hasattr(fn, "bf16_launches")})


def _deterministic(on: bool):
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def _rank_entry(rank, world, store, job, out, args):
    """One rank on the card: joins a process group of ``world`` ranks
    through a file store, on the backend the layout gives (gloo where the
    ranks share the card), and runs ``job``; its result goes to
    ``<out>/<job>-rank<r>.json``."""
    from mvsdet_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    backend = multihost.backend_for("cuda", local_ranks=world)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = RANK_JOBS[job](rank, out, *args)
    finally:
        dist.destroy_process_group()
    result.update(rank=rank, backend=backend)
    with open(Path(out) / f"{job}-rank{rank}.json", "w") as f:
        json.dump(result, f)


def run_ranks(job, world, *args, timeout=600):
    """``job`` on ``world`` spawned ranks (all on the one card); every
    rank's result, in rank order."""
    import torch.multiprocessing as mp

    out = Path(__file__).resolve().parent / "build" / "parallel"
    out.mkdir(parents=True, exist_ok=True)
    store = out / f"{job}-store"
    store.unlink(missing_ok=True)
    for old in out.glob(f"{job}-rank*.json"):
        old.unlink()
    ctx = mp.start_processes(_rank_entry,
                             args=(world, str(store), job, str(out), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job}: ranks did not finish in {timeout} s")
    results = []
    for r in range(world):
        with open(out / f"{job}-rank{r}.json") as f:
            results.append(json.load(f))
    return results


def _params_digest(model):
    import hashlib
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode() + t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def job_train(rank, out, data, view, dtype_name, steps, grads_path):
    """``steps`` sharded steps through `fit` of `scannet_config()` at full
    width from the seeded weights on a ``data x view`` mesh, data row d on
    synthetic scene PARALLEL_SCENE_SEEDS[d] (40 views, 2 targets).  The
    first step's averaged gradients go to ``grads_path`` (rank 0, on the
    host) when it is given; the last step's collectives are timed, each
    between two device synchronisations, so the step before it is the
    one whose time counts."""
    from unittest import mock

    from mvsdet_torch.config import scannet_config
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.parallel import sharding
    from mvsdet_torch.parallel.mesh import make_mesh
    from mvsdet_torch.training.loop import create_train_state, fit

    dtype = getattr(torch, dtype_name)
    cfg = scannet_config()
    _deterministic(dtype == torch.float32)
    mesh = make_mesh(data, view)
    scene = make_synthetic_scene(
        cfg, seed=PARALLEL_SCENE_SEEDS[mesh.data_index],
        n_views=cfg.data.n_src_train,
        n_targets=cfg.data.nerf_target_views_train)
    state = create_train_state(
        cfg, device="cuda", dtype=dtype,
        generator=torch.Generator().manual_seed(cfg.seed))
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    log = CollectiveLog()
    log.install()
    grads = {}
    apply_gradients = sharding.apply_gradients

    def update(state):
        if grads_path and rank == 0 and not grads:
            grads.update({k: p.grad.detach().cpu()
                          for k, p in state.model.named_parameters()
                          if p.grad is not None})
        log.on = False
        apply_gradients(state)

    records = []
    t_prev = [0.0]

    def log_step(i, metrics):
        now = time.perf_counter()
        records.append(dict(step=i, ms=(now - t_prev[0]) * 1e3, **metrics))
        t_prev[0] = now
        log.on = i + 1 == steps - 1       # time the last step's collectives

    fns = _launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fns)
    log.on = steps == 1
    t_prev[0] = time.perf_counter()
    with mock.patch.object(sharding, "apply_gradients", update):
        fit(state, (scene for _ in range(steps)), steps, log_every=1,
            log_fn=log_step, mesh=mesh)
    launches, bf16_launches = _read_launches(fns)
    if grads and rank == 0:
        torch.save(grads, grads_path)
    trainable = [k for k, p in state.model.named_parameters()
                 if p.requires_grad]
    moved = sum(not torch.equal(p.detach(), before[k])
                for k, p in state.model.named_parameters()
                if k in trainable)
    return dict(records=records, launches=launches,
                bf16_launches=bf16_launches,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                collectives=log.summary(), moved=moved,
                trainable=len(trainable),
                digest=_params_digest(state.model),
                local_views=int(sharding.shard_batch(
                    scene, mesh)["images"].shape[0]))


def job_nccl(rank, out):
    """World size 1: one step of the same state through
    `make_sharded_train_step` (via `fit`) and through `train_step`, cuDNN
    deterministic: whether the two states end bit-equal."""
    from mvsdet_torch.config import scannet_config
    from mvsdet_torch.data.prefetch import stage_batch
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.parallel.mesh import make_mesh
    from mvsdet_torch.training.loop import create_train_state, fit, train_step

    cfg = scannet_config()
    _deterministic(True)
    scene = make_synthetic_scene(cfg, seed=0, n_views=cfg.data.n_src_train,
                                 n_targets=cfg.data.nerf_target_views_train)
    mesh = make_mesh(1, 1)
    fns = _launch_counts()
    states, metrics = [], []
    for sharded in (True, False):
        state = create_train_state(
            cfg, device="cuda",
            generator=torch.Generator().manual_seed(cfg.seed))
        _reset_launches(fns)
        if sharded:
            logged = []
            fit(state, [scene], 1, log_fn=lambda i, m: logged.append(m),
                mesh=mesh)
            metrics.append(logged[0])
            launches = _read_launches(fns)[0]
        else:
            m = train_step(state, stage_batch(scene, "cuda"))
            metrics.append({k: float(v) for k, v in m.items()})
        states.append(state.model.state_dict())
        del state
    equal = [k for k in states[0] if torch.equal(states[0][k], states[1][k])]
    return dict(metrics=metrics, launches=launches,
                tensors=len(states[0]), bit_equal=len(equal),
                differ=[k for k in states[0] if k not in equal][:5],
                metrics_equal=metrics[0] == metrics[1])


def job_predict(rank, out, checkpoint, n_scenes):
    """The test launcher's `evaluate` with `--data-parallel` of every rank
    from ``checkpoint`` on ``n_scenes`` synthetic 80-view scenes, without
    and then with `--diagnostics`: for each, its metric dict, the boxes,
    scores and labels each scene gave the mAP, and its launches (the
    one-channel K1 launches apart)."""
    from unittest import mock

    from mvsdet_torch.config import scannet_config
    from mvsdet_torch.evaluation import harness
    from mvsdet_torch.evaluation.indoor_eval import indoor_map
    from mvsdet_torch.tools import test as test_launcher

    # as `launch_test_vs_plain` ran the same evaluations one scene at a time
    torch.backends.cudnn.deterministic = True
    world = dist.get_world_size()
    fns = _launch_counts()
    runs = {}
    for run, extra in (("predict", []), ("diagnostics", ["--diagnostics"])):
        scored = []

        def scoring_map(preds, gts, **kwargs):
            scored.extend(preds)
            return indoor_map(preds, gts, **kwargs)

        _reset_launches(fns)
        with mock.patch.object(harness, "indoor_map", scoring_map):
            results = test_launcher.evaluate(
                scannet_config(), test_launcher.parse_args(
                    ["--synthetic", str(n_scenes), "--checkpoint", checkpoint,
                     "--data-parallel", str(world)] + extra))
        launches, bf16_launches = _read_launches(fns)
        runs[run] = dict(results=results, launches=launches,
                         bf16_launches=bf16_launches,
                         c1_launches=fns["composite_tiles"].c1_launches,
                         preds=[{k: v.tolist() for k, v in p.items()}
                                for p in scored])
    return dict(runs=runs,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


RANK_JOBS = {"train": job_train, "nccl": job_nccl, "predict": job_predict}


def _rel_all(a, b):
    """|a - b| / |b| over every leaf together."""
    return math.sqrt(sum(float((a[k] - b[k]).square().sum()) for k in b)
                     / sum(float(b[k].square().sum()) for k in b))


def _rel_by_leaf(a, b):
    return {k: (torch.linalg.vector_norm(a[k] - b[k])
                / torch.linalg.vector_norm(b[k]).clamp_min(1e-30)).item()
            for k in b}


def parallel_train_phase(cfg):
    """`parallel_train`: one sharded float32 step at view 2 and at data 2
    (2 ranks on the card) against the unsharded step from the same
    weights here, then `parallel_train_bf16` (data 2 x view 2, 4 ranks)
    and `parallel_nccl` (world size 1).

    The data-2 step is held to the bounds of `train_vs_plain` (losses
    1e-5, every gradient 1e-4 relative): each rank computes a whole scene
    as the unsharded step does.  The view-2 step runs the backbone on 20
    views at a time, CostRegNet on the ranks' chunks of 5 references and
    sums its volume as two ranks' sums, which round otherwise than the
    unsharded step; at full width a rounding-level change can move a
    depth plane across the top-k boundary, and the step with it.  So at
    view 2 the reference is the unsharded step batched as the ranks batch
    (`as_ranks`: the backbone on each half of the views, the ranks'
    sweep chunk, the lift summed as two halves): the losses keep the
    1e-5 bound against it, and the gradients' largest leaf and all of
    them together may be twice the witness's distance from it, the
    witness being how far the lift's two halves alone move the plain
    unsharded step."""
    from mvsdet_torch.data.prefetch import stage_batch
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.models import mvsdet as mvsdet_module
    from mvsdet_torch.models.head import head_loss
    from mvsdet_torch.training.loop import create_train_state

    _deterministic(True)
    scenes = [make_synthetic_scene(cfg, seed=s, n_views=cfg.data.n_src_train,
                                   n_targets=cfg.data.nerf_target_views_train)
              for s in PARALLEL_SCENE_SEEDS]
    model = create_train_state(
        cfg, device="cuda",
        generator=torch.Generator().manual_seed(cfg.seed)).model
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    lift = mvsdet_module.lift_features_to_voxels

    def lift_halves(features, projections, est_depth, est_prob, points, vz):
        """The lift of each half of the views, summed (as two view ranks'
        psum sums them)."""
        h = features.shape[0] // 2
        a, b = (lift(features[s], projections[s], est_depth[s], est_prob[s],
                     points, vz) for s in (slice(0, h), slice(h, None)))
        return a[0] + b[0], a[1] + b[1]

    image_features = model.image_features

    def features_halves(images):
        """The backbone on each half of the views (as two view ranks run
        it)."""
        h = images.shape[0] // 2
        return torch.cat([image_features(images[:h]),
                          image_features(images[h:])])

    def unsharded(scene, n_pos=None, halves=False, as_ranks=False):
        """The loss terms and gradients of one scene from the initial
        weights, the head's positive count set to ``n_pos`` if given, the
        lift split into two halves with ``halves``, and with ``as_ranks``
        also the backbone and the sweep chunks as two view ranks batch
        them."""
        model.load_state_dict(initial)
        model.zero_grad(set_to_none=True)
        batch = stage_batch(scene, "cuda")
        if halves or as_ranks:
            n = scene["images"].shape[0] // 2
            chunk = max(c for c in range(1, model.sweep_chunk + 1)
                        if n % c == 0)
            with mock.patch.object(mvsdet_module, "lift_features_to_voxels",
                                   lift_halves), \
                    mock.patch.object(model, "image_features",
                                      features_halves if as_ranks
                                      else image_features), \
                    mock.patch.object(model, "sweep_chunk",
                                      chunk if as_ranks
                                      else model.sweep_chunk):
                total, aux = model.loss(batch)
        elif n_pos is None:
            total, aux = model.loss(batch)
        else:
            result = model(batch, train=True)
            losses, aux = head_loss(
                result["head_outs"], result["points"], result["valids"],
                batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
                cfg.model.head, n_pos_override=n_pos)
            losses["loss_nvs"] = torch.mean(
                (result["rendered"] - batch["gt_images"]) ** 2)
            total = sum(losses.values())
            aux.update(losses)
        total.backward()
        return ({"loss": total.item(), **{k: v.item() for k, v in aux.items()}},
                {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None})

    plain_ref = unsharded(scenes[0])
    halves_ref = unsharded(scenes[0], halves=True)
    view_ref = unsharded(scenes[0], as_ranks=True)
    witness = _rel_by_leaf(halves_ref[1], plain_ref[1])
    n_pos = sum(unsharded(s)[0]["n_pos"] for s in scenes) / len(scenes)
    per_scene = [unsharded(s, n_pos) for s in scenes]
    data_ref = ({k: sum(m[k] for m, _ in per_scene) / len(scenes)
                 for k in per_scene[0][0]},
                {k: sum(g[k] for _, g in per_scene) / len(scenes)
                 for k in per_scene[0][1]})
    data_ref[0]["n_pos"] = n_pos
    del model, initial, per_scene
    torch.cuda.empty_cache()
    _deterministic(False)

    grads_path = str(Path(__file__).resolve().parent / "build" / "parallel"
                     / "grads.pt")
    witness_all = _rel_all(halves_ref[1], plain_ref[1])
    for name, data, view, ref in (("view2", 1, 2, view_ref),
                                  ("data2", 2, 1, data_ref)):
        ranks = run_ranks("train", 2, data, view, "float32", 3, grads_path)
        got = torch.load(grads_path, weights_only=True)
        want_metrics, want_grads = ref
        metrics = {k: v for k, v in ranks[0]["records"][0].items()
                   if k not in ("step", "ms")}
        loss_rel = {k: abs(metrics[k] - v) / max(abs(v), 1e-30)
                    for k, v in want_metrics.items()}
        grad_rel = _rel_by_leaf(got, want_grads)
        worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
        all_rel = _rel_all(got, want_grads)
        if name == "view2":
            leaf_tol = 2 * max(witness.values())
            all_tol = 2 * witness_all
            extra = dict(witness_max_grad_rel_err=max(witness.values()),
                         witness_all_grads_rel_err=witness_all,
                         plain_loss_rel_err={
                             k: abs(metrics[k] - v) / max(abs(v), 1e-30)
                             for k, v in plain_ref[0].items()},
                         plain_max_grad_rel_err=max(_rel_by_leaf(
                             got, plain_ref[1]).values()))
        else:
            leaf_tol, all_tol, extra = 1e-4, 1e-4, {}
        emit(phase="parallel_train", case=name, dtype="float32",
             data=data, view=view, backend=ranks[0]["backend"],
             local_views=ranks[0]["local_views"],
             reference="the unsharded step batched as the ranks batch"
             if name == "view2"
             else "mean of the unsharded scenes, n_pos their mean",
             loss_rel_err=loss_rel, max_grad_rel_err=worst[0][1],
             all_grads_rel_err=all_rel, grad_tolerance=[leaf_tol, all_tol],
             worst_grads=worst, n_grads=len(grad_rel), **extra,
             ranks=[dict(rank=r["rank"], step_ms=[s["ms"] for s in
                                                  r["records"]],
                         peak_memory_gb=r["peak_memory_gb"],
                         launches=r["launches"],
                         collectives=r["collectives"]) for r in ranks])
        check(set(got) == set(want_grads), f"parallel_train {name}: "
              f"gradients of other parameters than the unsharded step's")
        check(max(loss_rel.values()) <= 1e-5,
              f"parallel_train {name}: losses differ: {loss_rel}")
        check(worst[0][1] <= leaf_tol and all_rel <= all_tol,
              f"parallel_train {name}: gradients differ: {worst}, all "
              f"{all_rel}, bounds {leaf_tol}, {all_tol}")
        check(len({r["digest"] for r in ranks}) == 1,
              f"parallel_train {name}: the ranks' parameters differ")
        for r in ranks:
            check(all(n == 3 for n in r["launches"].values()),
                  f"parallel_train {name} rank {r['rank']}: launches "
                  f"{r['launches']}, expected 3 each (3 steps)")
            check(r["backend"] == "gloo", f"parallel_train {name}: backend "
                                          f"{r['backend']} for 2 ranks on "
                                          f"one card")
        del got, want_grads
    del view_ref, plain_ref, halves_ref, data_ref

    # data 2 x view 2 in bf16 on 4 ranks
    ranks = run_ranks("train", 4, 2, 2, "bfloat16", 2, None)
    emit(phase="parallel_train_bf16", dtype="bfloat16", data=2, view=2,
         backend=ranks[0]["backend"], local_views=ranks[0]["local_views"],
         ranks=[dict(rank=r["rank"], step_ms=[s["ms"] for s in r["records"]],
                     losses=[s["loss"] for s in r["records"]],
                     peak_memory_gb=r["peak_memory_gb"],
                     launches=r["launches"], bf16_launches=r["bf16_launches"],
                     moved=r["moved"], collectives=r["collectives"])
                for r in ranks])
    check(len({r["digest"] for r in ranks}) == 1,
          "parallel_train_bf16: the 4 ranks' parameters are not bit-equal")
    for r in ranks:
        check(all(np.isfinite(v) for s in r["records"] for k, v in s.items()
                  if k != "step"), f"parallel_train_bf16 rank {r['rank']}: "
                                   f"{r['records']}")
        check(r["moved"] > 0.9 * r["trainable"],
              f"parallel_train_bf16 rank {r['rank']}: {r['moved']} of "
              f"{r['trainable']} trainable parameters moved")
        check(all(n == 2 for n in r["launches"].values()) and all(
            r["bf16_launches"][k] == 2 for k in (
                "weighted_gather_sum", "weighted_gather_sum_dfeat",
                "weighted_gather_sum_dweight")),
              f"parallel_train_bf16 rank {r['rank']}: launches "
              f"{r['launches']}, bf16 {r['bf16_launches']}")

    (r,) = run_ranks("nccl", 1)
    emit(phase="parallel_nccl", backend=r["backend"], world=1,
         tensors=r["tensors"], bit_equal=r["bit_equal"], differ=r["differ"],
         metrics=r["metrics"], launches=r["launches"])
    check(r["backend"] == "nccl", f"parallel_nccl: backend {r['backend']}")
    check(r["bit_equal"] == r["tensors"] and r["metrics_equal"],
          f"parallel_nccl: the sharded step at world size 1 is not the "
          f"unsharded step bit for bit: {r['differ']}, {r['metrics']}")
    check(all(n == 1 for n in r["launches"].values()),
          f"parallel_nccl: launches {r['launches']}")


def parallel_predict_phase(checkpoint, n_scenes, single, single_scored):
    """`parallel_predict`: the test launcher's evaluation with
    `--data-parallel 2` on 2 ranks, without and then with `--diagnostics`,
    against the same evaluations one scene at a time (``single[run]``,
    with the boxes, scores and labels each scene gave the mAP,
    ``single_scored[run]``)."""
    ranks = run_ranks("predict", 2, str(checkpoint), n_scenes)
    for run in ("predict", "diagnostics"):
        diagnostics = run == "diagnostics"
        tag = "parallel_predict" + " --diagnostics" * diagnostics
        by_rank = [r["runs"][run] for r in ranks]
        got, want = by_rank[0]["results"], single[run]
        aps = sorted(k for k in want if k.startswith(("AP_", "mAP", "mAR")))
        ap_equal = set(got) == set(want) and all(got[k] == want[k]
                                                 for k in aps)
        nvs_rel = {k: abs(got[k] - want[k]) / abs(want[k])
                   for k in ("psnr", "ssim")}
        diag_rel = {k: abs(got[k] - want[k]) / abs(want[k])
                    for k in DIAGNOSTICS_METRICS if diagnostics}
        pairs = list(zip(by_rank[0]["preds"], single_scored[run]))
        preds_equal = len(pairs) == n_scenes and all(
            np.array_equal(a["labels"], b["labels"])
            and np.allclose(a["boxes"], b["boxes"], rtol=1e-5, atol=1e-5)
            and np.allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-5)
            for a, b in pairs)
        emit(phase="parallel_predict", backend=ranks[0]["backend"], ranks=2,
             group_size=2, scenes=n_scenes, diagnostics=diagnostics,
             aps_equal=ap_equal, nvs_rel_err=nvs_rel,
             diagnostics_rel_err=diag_rel,
             diagnostics_metrics={k: got[k] for k in diag_rel},
             preds_equal=preds_equal, map_025=got["mAP_0.25"],
             predict_s=[(r["results"]["predict_s_first"],
                         r["results"].get("predict_s_per_scene"))
                        for r in by_rank],
             launches=[r["launches"] for r in by_rank],
             c1_launches=[r["c1_launches"] for r in by_rank],
             peak_memory_gb=[r["peak_memory_gb"] for r in ranks])
        untimed = lambda res: {k: v for k, v in res.items()
                               if not k.startswith("predict_s")}
        check(all(untimed(r["results"]) == untimed(got) for r in by_rank[1:]),
              f"{tag}: the ranks' metrics differ")
        check(preds_equal, f"{tag}: the boxes, scores or labels given to the "
                           f"mAP differ from one scene at a time's")
        check(got["mAP_0.25"] > 0, f"{tag}: nothing detected, so the APs' "
                                   f"equality would hold trivially")
        check(ap_equal, f"{tag}: APs differ: {got} against {want}")
        check(max(nvs_rel.values()) <= 1e-4,
              f"{tag}: psnr/ssim differ by {nvs_rel}")
        check(not diagnostics or (diag_rel.keys() == set(DIAGNOSTICS_METRICS)
                                  and max(diag_rel.values()) <= 1e-5),
              f"{tag}: the diagnostics differ by {diag_rel}")
        for rank, r in enumerate(by_rank):
            # each rank predicts one scene of each group of 2, the last
            # padded: K1 once a scene and K3 once, K1 once more with one
            # channel (the rendered depth) under the diagnostics
            want_launches = {
                name: {"composite_tiles": 2 + 2 * diagnostics,
                       "weighted_gather_sum": 2}.get(name, 0)
                for name in r["launches"]}
            check(r["launches"] == want_launches
                  and r["c1_launches"] == 2 * diagnostics,
                  f"{tag} rank {rank}: launches {r['launches']}, "
                  f"one-channel K1 {r['c1_launches']}")


def launch_rank(out: str, argv) -> None:
    """One process of `launch_train_parallel` under torchrun: the train
    launcher's `main`, then this rank's launches and parameters' digest
    in ``<out>/rank<RANK>.json``."""
    import os

    from mvsdet_torch.tools import train as train_launcher

    fns = _launch_counts()
    _reset_launches(fns)
    state = train_launcher.main(argv)
    launches, bf16_launches = _read_launches(fns)
    with open(Path(out) / f"rank{os.environ['RANK']}.json", "w") as f:
        json.dump(dict(launches=launches, bf16_launches=bf16_launches,
                       digest=_params_digest(state.model), step=state.step),
                  f)


def launch_train_parallel_phase():
    """`launch_train_parallel`: the train launcher under `torch.distributed
    .run --standalone --nproc_per_node 2` with `--data-parallel 2`, bf16,
    2 steps: exit 0, finite step records written by rank 0, both ranks'
    launches and equal parameters."""
    root = Path(__file__).resolve().parent
    work = root / "build" / "launch_parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(root / "chip_smoke.py"),
         "--launch-rank", str(work), "--synthetic", "2", "--steps", "2",
         "--data-parallel", "2", "--dtype", "bfloat16", "--log-every", "1",
         "--work-dir", str(work / "run")],
        cwd=root, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"launch_train_parallel: exit "
                               f"{res.returncode}\n{res.stderr[-3000:]}")
    with open(work / "run" / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "loss" in r]
    ranks = []
    for r in range(2):
        with open(work / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    emit(phase="launch_train_parallel", dtype="bfloat16", layout=log[0],
         steps=len(steps), step_times_s=[r["time"] for r in steps],
         losses=[r["loss"] for r in steps], command_s=seconds,
         launches=[r["launches"] for r in ranks],
         bf16_launches=[r["bf16_launches"] for r in ranks])
    check(log[0].get("backend") == "gloo" and log[0].get("world") == 2,
          f"launch_train_parallel: layout {log[0]}")
    check(len(steps) == 2 and all(np.isfinite(v) for r in steps
                                  for v in r.values()),
          f"launch_train_parallel: step records {steps}")
    check((work / "run" / "latest").is_file(),
          "launch_train_parallel: latest was not written")
    check(len({r["digest"] for r in ranks}) == 1,
          "launch_train_parallel: the ranks' parameters differ")
    for r in ranks:
        check(all(n == 2 for n in r["launches"].values()) and all(
            r["bf16_launches"][k] == 2 for k in (
                "weighted_gather_sum", "weighted_gather_sum_dfeat",
                "weighted_gather_sum_dweight")),
              f"launch_train_parallel: launches {r['launches']}, bf16 "
              f"{r['bf16_launches']}")


# -- the legacy NeRF-Det: no kernel of ops/csrc on its path ------------------

NERFDET_STEPS = 3
NERFDET_CPU_VIEWS = 8       # the CPU side of nerfdet_vs_cpu stays in seconds


def nerfdet_phases(cfg, scene, reset_launches, read_launches,
                   dtype=torch.float32):
    """`nerfdet_train`, `nerfdet_vs_cpu` and `launch_train_nerfdet`: the
    legacy NeRF-Det at `scannet_config()` width computing in ``dtype`` (40
    source views and 2 targets, 2048 rays of 64 samples a step), each run
    with the launch counts set to 0 just before and read just after:
    NeRF-Det launches none of the kernels, and every count must stay 0.
    Every line names its ``dtype``."""
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.evaluation.harness import make_predict_fn
    from mvsdet_torch.models.mvsdet import init_weights
    from mvsdet_torch.models.nerfdet import NerfDetLegacy
    from mvsdet_torch.tools import train as train_launcher
    from mvsdet_torch.training.loop import (TrainState, create_nerfdet_state,
                                            fit)
    from mvsdet_torch.training.optim import apply_gradients, build_optimizer

    label = str(dtype).replace("torch.", "")
    bf16 = torch.bfloat16

    def check_none_launched(launches, bf16_launches, run):
        check(not any(launches.values()) and not any(bf16_launches.values()),
              f"{run} {label}: NeRF-Det launched a kernel: {launches}, bf16 "
              f"{bf16_launches}")

    # -- nerfdet_train: NERFDET_STEPS steps through fit --------------------
    state = create_nerfdet_state(
        cfg, device="cuda", generator=torch.Generator().manual_seed(cfg.seed),
        dtype=dtype)
    model = state.model
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    step_logs = []
    t_start = [0.0]

    def log_step(i, metrics):
        now = time.perf_counter()
        step_logs.append(dict(step=i, latency_ms=(now - t_start[0]) * 1e3,
                              **metrics))
        t_start[0] = now
        emit(phase="nerfdet_train", dtype=label, **step_logs[-1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_start[0] = time.perf_counter()
    fit(state, (scene for _ in range(NERFDET_STEPS)), NERFDET_STEPS,
        log_every=1, log_fn=log_step)
    launches, bf16_launches = read_launches()
    steady = [s["latency_ms"] for s in step_logs[1:]]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    moved = sum(not torch.equal(model.get_parameter(n).detach(), params0[n])
                for n in trainable)
    state_dtypes = sorted({str(t.dtype) for t in (
        list(model.parameters()) + list(model.buffers())
        + [v for st in state.optimizer.state.values()
           for v in st.values() if torch.is_tensor(v) and v.ndim])})
    emit(phase="nerfdet_train", dtype=label, steps=NERFDET_STEPS,
         views=cfg.data.n_src_train,
         targets=cfg.data.nerf_target_views_train, n_rand=model.n_rand,
         n_samples=model.n_samples, launches=launches,
         bf16_launches=bf16_launches,
         first_step_ms=step_logs[0]["latency_ms"],
         steady_step_ms=statistics.mean(steady), steady_steps_ms=steady,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         parameters_moved=moved, trainable_parameters=len(trainable),
         state_dtypes=state_dtypes)
    check_none_launched(launches, bf16_launches, "nerfdet_train")
    for log in step_logs:
        check(all(np.isfinite(v) for k, v in log.items()
                  if k not in ("step", "latency_ms")),
              f"nerfdet_train {label} step {log['step']}: a loss is not "
              f"finite: {log}")
        check(log["loss_nvs"] > 0 and "loss_depth" in log,
              f"nerfdet_train {label} step {log['step']}: no colour loss: "
              f"{log}")
    check(moved > 0.9 * len(trainable),
          f"nerfdet_train {label}: only {moved} of {len(trainable)} "
          f"trainable parameters moved")
    check(state_dtypes == ["torch.float32"],
          f"nerfdet_train {label}: parameters, statistics or AdamW state in "
          f"{state_dtypes}")
    del state, model, params0
    torch.cuda.empty_cache()

    # -- nerfdet_vs_cpu: one loss and gradient, card against CPU -----------
    small = make_synthetic_scene(cfg, seed=1, n_views=NERFDET_CPU_VIEWS,
                                 n_targets=cfg.data.nerf_target_views_train)
    base = NerfDetLegacy(cfg.model, dtype=dtype)
    init_weights(base, torch.Generator().manual_seed(cfg.seed))
    base.train()
    cpu_batch = {k: torch.as_tensor(v) for k, v in small.items()}
    rays = base.draw_rays(cpu_batch, torch.Generator().manual_seed(7))

    def loss_and_grads(model, batch, rays):
        t0 = time.perf_counter()
        total, aux = model.loss(batch, rays=rays)
        total.backward()
        values = {k: v.item() for k, v in aux.items()} | {"loss": total.item()}
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        return values, grads, time.perf_counter() - t0

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    on_card = copy.deepcopy(base).cuda()
    # the card's dtypes where the compute dtype meets float32, recorded as
    # tests/test_torch_port_nerfdet_bf16.py records the CPU's
    seen = {}

    def record(name):
        def hook(mod, args):            # returns None: the inputs stand
            seen.setdefault(name, args[0].dtype)
        return hook

    hooks = [on_card.backbone.register_forward_pre_hook(record("images")),
             on_card.neck3d.register_forward_pre_hook(record("volume"))]
    density, branch = on_card.voxel_density, on_card.nerf_branch

    def recorded_density(*args):
        alpha = density(*args)
        seen.setdefault("alpha", alpha.dtype)
        return alpha

    def recorded_branch(*args):
        render = branch(*args)
        if render is not None:
            seen.setdefault("render", (render["rgb"].dtype,
                                       render["depth"].dtype))
        return render

    on_card.voxel_density = recorded_density
    on_card.nerf_branch = recorded_branch
    reset_launches()
    card, card_grads, card_s = loss_and_grads(
        on_card, {k: v.cuda() for k, v in cpu_batch.items()},
        {k: v.cuda() for k, v in rays.items()})
    launches, bf16_launches = read_launches()
    for h in hooks:
        h.remove()
    del on_card.voxel_density, on_card.nerf_branch
    want_dtypes = dict(images=dtype, alpha=dtype, volume=dtype,
                       render=(dtype, torch.float32))
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    cpu, cpu_grads, cpu_s = loss_and_grads(copy.deepcopy(base), cpu_batch,
                                           rays)
    if dtype == bf16:
        # the witness: the same CPU step computing in float32.  The card's
        # bf16 roundings and the CPU's fall apart, each about as far from
        # float32 as bf16 is (tests/test_torch_port_nerfdet_bf16.py); one
        # float32 ulp of the weights changes almost no bf16 operand, and
        # one bf16 ulp up of every weight moves the whole network
        nudged = NerfDetLegacy(cfg.model)
        nudged.load_state_dict(base.state_dict())
        witness_batch = cpu_batch
    else:
        # the witness: the CPU step with the source views in reverse order
        # and every parameter one ulp up, a change of summation order and
        # of the weights' last bits alone
        nudged = copy.deepcopy(base)
        with torch.no_grad():
            for p in nudged.parameters():
                p.copy_(torch.nextafter(p, torch.tensor(math.inf)))
        witness_batch = dict(cpu_batch, **{
            k: cpu_batch[k].flip(0) for k in ("images", "denorm_images",
                                              "w2c")})
    nudged.train()
    witness_losses, witness_grads, _ = loss_and_grads(nudged, witness_batch,
                                                      rays)
    loss_rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
                for k in cpu}
    witness_loss_rel = {k: abs(witness_losses[k] - cpu[k])
                        / max(abs(cpu[k]), 1e-30) for k in cpu}
    grad_rel = _rel_by_leaf(card_grads, cpu_grads)
    witness_rel = _rel_by_leaf(witness_grads, cpu_grads)
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:5]
    all_rel = _rel_all(card_grads, cpu_grads)
    witness_all = _rel_all(witness_grads, cpu_grads)
    witness_max = max(witness_rel.values())

    # predict with the card's weights after that step's update, on the
    # card and on the CPU.  Random weights score every box near 0.005,
    # under score_thr (0.01), so the predicts keep every NMS survivor
    state = TrainState(on_card, *build_optimizer(cfg.optim, on_card),
                       max_norm=cfg.optim.grad_clip_norm)
    apply_gradients(state)
    on_card.cfg = dataclasses.replace(cfg.model, head=dataclasses.replace(
        cfg.model.head, score_thr=0.0))
    on_card.eval()

    def predicted(model, device):
        """The predict of ``small`` and the head's outputs in it, each part
        (center, bbox, cls) of every level flattened into one float32
        vector on the host."""
        outs = []

        def hook(mod, args, out):
            outs.append(out)

        handle = model.head.register_forward_hook(hook)
        pred = make_predict_fn(model, device)(small)
        handle.remove()
        return pred, {part: torch.cat([level[i].detach().float().cpu()
                                       .reshape(-1) for level in outs[0]])
                      for i, part in enumerate(("center", "bbox", "cls"))}

    def norm_rel(got, want):
        return float((got - want).norm() / want.norm().clamp_min(1e-30))

    pred_card, head_card = predicted(on_card, "cuda")
    pred_cpu, head_cpu = predicted(copy.deepcopy(on_card).cpu(), "cpu")
    head_rel = {k: norm_rel(head_card[k], head_cpu[k]) for k in head_cpu}
    witness_head_rel = None
    if dtype == bf16:
        # the witness: the CPU's predict of the same weights in float32
        ref32 = NerfDetLegacy(on_card.cfg)
        ref32.load_state_dict(on_card.state_dict())
        head_32 = predicted(ref32.eval(), "cpu")[1]
        witness_head_rel = {k: norm_rel(head_32[k], head_cpu[k])
                            for k in head_cpu}
        del ref32
    mask = pred_card["mask"]
    preds_equal = bool(
        np.array_equal(mask, pred_cpu["mask"])
        and np.array_equal(pred_card["labels"][mask], pred_cpu["labels"][mask])
        and np.allclose(pred_card["boxes"][mask], pred_cpu["boxes"][mask],
                        rtol=1e-4, atol=1e-4))
    score_err = float(np.abs(pred_card["scores"][mask]
                             - pred_cpu["scores"][mask]).max(initial=0.0))
    # the share of the card's kept boxes that the CPU keeps too (a box of
    # the same label within 1e-3): in bf16 the scores tie and their
    # roundings differ between the two, and so does the NMS's order
    cpu_kept = [(l, b) for l, b, m in zip(
        pred_cpu["labels"], pred_cpu["boxes"], pred_cpu["mask"]) if m]
    matched = sum(any(l == cl and np.allclose(b, cb, atol=1e-3)
                      for cl, cb in cpu_kept)
                  for l, b in zip(pred_card["labels"][mask],
                                  pred_card["boxes"][mask]))
    # in bf16 the loss terms together (their vector's relative distance)
    # within twice the witness's; in float32 each within 1e-4
    terms = sorted(k for k in cpu if k != "n_pos")

    def terms_rel(values):
        return float(np.linalg.norm([values[k] - cpu[k] for k in terms])
                     / np.linalg.norm([cpu[k] for k in terms]))

    loss_vector_rel = terms_rel(card)
    witness_loss_vector_rel = terms_rel(witness_losses)
    losses_ok = card["n_pos"] == cpu["n_pos"] and (
        loss_vector_rel <= 2 * witness_loss_vector_rel if dtype == bf16
        else max(loss_rel.values()) <= 1e-4)
    emit(phase="nerfdet_vs_cpu", dtype=label, views=NERFDET_CPU_VIEWS,
         cpu_threads=torch.get_num_threads(), loss_rel_err=loss_rel,
         max_grad_rel_err=worst[0][1], worst_grads=worst,
         all_grads_rel_err=all_rel, witness_max_grad_rel_err=witness_max,
         witness_all_grads_rel_err=witness_all, n_grads=len(grad_rel),
         card_s=card_s, cpu_s=cpu_s, launches=launches,
         bf16_launches=bf16_launches, kept_boxes=int(mask.sum()),
         predict_equal_under_mask=preds_equal, max_score_abs_err=score_err,
         cpu_kept_boxes=len(cpu_kept), kept_share_matched=matched / max(
             int(mask.sum()), 1), witness_loss_rel_err=witness_loss_rel,
         loss_vector_rel_err=loss_vector_rel,
         witness_loss_vector_rel_err=witness_loss_vector_rel, losses=card,
         head_rel_err=head_rel, witness_head_rel_err=witness_head_rel,
         dtypes={k: str(v) for k, v in seen.items()})
    check_none_launched(launches, bf16_launches, "nerfdet_vs_cpu")
    check(seen == want_dtypes,
          f"nerfdet_vs_cpu {label}: the card computed in {seen}, not "
          f"{want_dtypes}")
    check(set(card_grads) == set(cpu_grads),
          f"nerfdet_vs_cpu {label}: the card and the CPU give gradients to "
          f"different parameters")
    check(cpu["loss_nvs"] > 0, f"nerfdet_vs_cpu {label}: no colour loss: "
                               f"{cpu}")
    check(losses_ok,
          f"nerfdet_vs_cpu {label}: loss terms differ: {loss_rel}, together "
          f"{loss_vector_rel} against the witness's {witness_loss_vector_rel}")
    check(worst[0][1] <= 2 * witness_max and all_rel <= 2 * witness_all,
          f"nerfdet_vs_cpu {label}: gradients differ from the CPU's by "
          f"{worst}, all {all_rel}, beyond twice the witness's "
          f"{witness_max}, all {witness_all}")
    if dtype == bf16:
        check(mask.sum() > 0 and len(cpu_kept) > 0 and all(
            np.all(np.isfinite(p[k])) for p in (pred_card, pred_cpu)
            for k in ("boxes", "scores")),
              f"nerfdet_vs_cpu {label}: kept {int(mask.sum())} boxes on the "
              f"card, {len(cpu_kept)} on the CPU, or not finite")
        # the predicts' head outputs, each part within twice its witness
        # (two independent bf16 roundings, as the gradients above)
        check(all(head_rel[k] <= 2 * witness_head_rel[k] for k in head_rel),
              f"nerfdet_vs_cpu {label}: the predict's head outputs differ "
              f"from the CPU's by {head_rel}, beyond twice the witness's "
              f"{witness_head_rel}")
    else:
        check(mask.sum() > 0 and preds_equal,
              f"nerfdet_vs_cpu: the predicts' kept boxes or labels differ "
              f"({int(mask.sum())} kept on the card)")
    del base, on_card, state, nudged
    torch.cuda.empty_cache()

    # -- launch_train_nerfdet: the train launcher as a user runs it --------
    work = Path(__file__).resolve().parent / "build" / \
        f"launch_nerfdet_{label}"
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    state = train_launcher.main([
        "--model", "nerfdet", "--synthetic", "2", "--steps", "4",
        "--val-synthetic", "1", "--dtype", label, "--work-dir", str(work)])
    launches, bf16_launches = read_launches()
    with open(work / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "loss" in r]
    evals = [r["eval"] for r in log if "eval" in r]
    saves = [r for r in log if "saved" in r]
    step_ms = [(b["time"] - a["time"]) * 1e3
               for a, b in zip(log, log[1:]) if "loss" in a and "loss" in b]
    emit(phase="launch_train_nerfdet", dtype=label, steps=len(steps),
         views=cfg.data.n_src_train, eval_views=cfg.data.n_src_test,
         first_step_ms=steps[0]["time"] * 1e3, steady_step_ms=step_ms,
         eval_predict_s=[e["predict_s_first"] for e in evals],
         eval_map_025=[e["mAP_0.25"] for e in evals],
         save_s={f"{r['saved']}@{r['step']}": r["save_s"] for r in saves},
         losses=[r["loss"] for r in steps],
         loss_nvs=[r["loss_nvs"] for r in steps], launches=launches,
         bf16_launches=bf16_launches)
    check_none_launched(launches, bf16_launches, "launch_train_nerfdet")
    check(len(steps) == 4 and all(np.isfinite(v) for r in steps
                                  for v in r.values())
          and all(r["loss_nvs"] > 0 for r in steps),
          f"launch_train_nerfdet {label}: step records {steps}")
    # an epoch is the 2 scenes: an evaluation after each
    check(len(evals) == 2 and all("mAP_0.25" in e for e in evals),
          f"launch_train_nerfdet {label}: evaluations {evals}")
    check((work / "latest").is_file() and (work / "best").is_file(),
          f"launch_train_nerfdet {label}: latest or best was not written")
    check(type(state.model).__name__ == "NerfDetLegacy" and state.step == 4
          and state.model.dtype == dtype,
          f"launch_train_nerfdet {label}: {type(state.model).__name__} in "
          f"{state.model.dtype} at step {state.step}")
    del state
    torch.cuda.empty_cache()


# -- overfit_map: the learning check on the card ------------------------------

OVERFIT_SEEDS = (0, 1, 2)
# (case, dtype, overfit_map.run's arguments, JAX's gate on the final
# mAP_0.25 and mAR_0.25: tests/test_learning.py, test_learning_nerfdet.py)
OVERFIT_CASES = (
    ("aligned", "float32", dict(steps=150, eval_every=50), 0.6, 0.6),
    ("aligned", "bfloat16", dict(steps=150, eval_every=50), 0.6, 0.6),
    ("rotated", "bfloat16", dict(steps=200, eval_every=50, arkit=True),
     0.6, 0.6),
    ("nerfdet", "float32", dict(steps=300, eval_every=100,
                                model_family="nerfdet"), 0.4, 0.5),
    ("nerfdet", "bfloat16", dict(steps=300, eval_every=100,
                                 model_family="nerfdet"), 0.4, 0.5),
)
OVERFIT_SCENES = 2
# the modes the cases run in, with the worker processes each takes on the
# card (a tiny step waits on the host's launches, so the runs overlap
# there; together they keep the host's 8 cores busy).  Deterministic
# algorithms, every case, gated: the overfit is chaotic (a rounding-level
# change can move a seed into another basin), and this mode gives one
# reproducible verdict on this card and software.  The card's default
# kernels, as users train, reported beside the gate, each run of the
# script another draw: MVSDet's cases (NeRF-Det's default-mode runs ended
# at its deterministic runs' finals on every seed and in both dtypes)
OVERFIT_MODES = {"deterministic": 5, "default": 3}


SWEEP_CPU_REFS = 2        # reference views the CPU sweeps for sweep_paths


def sweep_paths_phase(cfg, scene, predict_scenes):
    """`sweep_paths` (see the module docstring): the default mxu sweep
    against the gather on the step's 40-view scene, the card's mxu sweep
    against the CPU's, both sweeps' chunk, predict and step times."""
    from mvsdet_torch.evaluation.harness import make_predict_fn
    from mvsdet_torch.geometry.cameras import (full_projection,
                                               knn_camera_neighbors,
                                               scale_intrinsics)
    from mvsdet_torch.geometry.voxels import depth_plane_values
    from mvsdet_torch.models.mvsdet import build_model
    from mvsdet_torch.ops import plane_sweep_mxu
    from mvsdet_torch.ops.plane_sweep import plane_sweep_variance_for_refs
    from mvsdet_torch.ops.plane_sweep_mxu import plane_sweep_variance_mxu
    from mvsdet_torch.training.loop import create_train_state, fit

    mc = cfg.model
    batch = {k: torch.as_tensor(v).cuda() for k, v in scene.items()}
    n = batch["images"].shape[0]
    proj44 = full_projection(batch["w2c"], scale_intrinsics(
        batch["intrinsic"], float(mc.feature_stride)))
    nb = knn_camera_neighbors(torch.linalg.inv_ex(batch["w2c"]).inverse[
        :, :3, 3], min(mc.plane_sweep_neighbors, n - 1))
    depths = depth_plane_values(*mc.near_far_range, mc.gs.num_depth_planes,
                                device="cuda")
    sweeps = {"mxu": plane_sweep_variance_mxu,
              "gather": lambda *a, compute_dtype:
              plane_sweep_variance_for_refs(*a)}
    gen = lambda: torch.Generator().manual_seed(cfg.seed)    # noqa: E731

    def step_times(step_cfg, compute_dtype, **line):
        """TRAIN_STEPS steps of one train state through `fit` with each
        sweep: the step times and the peak memory."""
        state = create_train_state(step_cfg, device="cuda",
                                   dtype=compute_dtype, generator=gen())
        for method in ("mxu", "gather"):
            state.model.sweep_method = method
            times, t_last = [], [0.0]

            def log_step(i, metrics):
                now = time.perf_counter()
                times.append((now - t_last[0]) * 1e3)
                t_last[0] = now

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_last[0] = time.perf_counter()
            fit(state, (scene for _ in range(TRAIN_STEPS)), TRAIN_STEPS,
                log_every=1, log_fn=log_step)
            emit(phase="sweep_paths", **line, sweep=method, step_views=n,
                 step_ms=times, steady_step_ms=statistics.mean(times[1:]),
                 step_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del state
        torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).replace("torch.", "")
        model = build_model(cfg, device="cuda", dtype=dtype, generator=gen())
        with torch.no_grad():
            feats = model.image_features(batch["images"].to(dtype)).float()
            out = {}
            for method in ("mxu", "gather"):
                model.sweep_method = method
                prob, off = model.depth_probabilities(feats, proj44, nb)
                est, _, expect = model.sample_depth(prob, off)
                out[method] = (prob, est, expect)
        (pm, em, xm), (pg, eg, xg) = out["mxu"], out["gather"]
        corr = torch.corrcoef(torch.stack([pm.flatten(), pg.flatten()])
                              .double())[0, 1].item()
        diff = (xm - xg).double()
        emit(phase="sweep_paths", dtype=label, views=n,
             planes=int(depths.shape[0]), neighbours=int(nb.shape[1]),
             feature_shape=list(feats.shape[1:]),
             top1_plane_agreement=(pm.argmax(1) == pg.argmax(1)).double()
             .mean().item(), prob_corr=corr,
             topk_depth_set_match=((em.sort(-1).values - eg.sort(-1).values)
                                   .abs() < 0.1 * mc.depth_interval)
             .double().mean().item(),
             depth_expect_rmse_m=diff.square().mean().sqrt().item(),
             depth_expect_max_abs_m=diff.abs().max().item())
        check(all(torch.isfinite(t).all() for t in (pm, pg, xm, xg)),
              f"sweep_paths {label}: depth probabilities not finite")
        del out, pm, pg, em, eg, xm, xg, diff

        # the card's mxu sweep against the CPU's on a few reference views.
        # The warp from one set of homographies (the CPU's) on both: their
        # products sum in other orders.  The whole sweep, each device
        # taking its own inverse and homographies: a sample position's
        # float32 rounding moves its weights, so that difference is held
        # beside its witness, the CPU's sweep from projections one float32
        # ulp away.  The variance's subtraction E[f^2] - E[f]^2 cancels:
        # its rounding is that of E[f^2]
        refs = torch.arange(SWEEP_CPU_REFS, device="cuda")

        def sweep_mxu(dev, compute_dtype, proj=proj44):
            warp = Recorder(plane_sweep_mxu._warp)
            with mock.patch.object(plane_sweep_mxu, "_warp", warp):
                var = plane_sweep_variance_mxu(
                    feats.to(dev), proj.to(dev), refs.to(dev),
                    nb[refs].to(dev), depths.to(dev),
                    compute_dtype=compute_dtype)
            return warp.out.cpu(), var.cpu(), warp.args

        warp_card, var_card, _ = sweep_mxu("cuda", dtype)
        warp_cpu, var_cpu, (src, homos, _) = sweep_mxu("cpu", dtype)
        same = plane_sweep_mxu._warp(src.cuda(), homos.cuda(), dtype).cpu()
        ulp = sweep_mxu("cpu", dtype, torch.nextafter(
            proj44, torch.full_like(proj44, math.inf)))
        ref = feats[refs].cpu()[:, None]
        k = nb.shape[1]
        square = ((ref**2 + warp_cpu.reshape((len(refs), k)
                                             + warp_cpu.shape[1:])
                   .square().sum(1)) / (k + 1)).abs().max().item()
        same_err = (same - warp_cpu).abs().max().item()
        warp_err = (warp_card - warp_cpu).abs().max().item()
        var_err = (var_card - var_cpu).abs().max().item()
        warp_ulp = (ulp[0] - warp_cpu).abs().max().item()
        var_ulp = (ulp[1] - var_cpu).abs().max().item()
        warp_scale = warp_cpu.abs().max().item()
        line = dict(phase="sweep_paths", dtype=label, check="card_vs_cpu",
                    refs=SWEEP_CPU_REFS, same_homographies_warp_err=same_err,
                    warp_max_abs_err=warp_err, warp_ulp_witness=warp_ulp,
                    warp_max_abs=warp_scale, variance_max_abs_err=var_err,
                    variance_ulp_witness=var_ulp,
                    variance_max_abs=var_cpu.abs().max().item(),
                    mean_square_max=square)
        if dtype == torch.float32:
            emit(**line, same_homographies_rel_err=same_err / warp_scale)
            check(same_err <= 1e-5 * warp_scale,
                  f"sweep_paths: the card's float32 mxu warp differs from "
                  f"the CPU's by {same_err} (max {warp_scale})")
        else:
            witness = (same - plane_sweep_mxu._warp(
                src.cuda(), homos.cuda(), torch.float32).cpu()
                       ).abs().max().item()
            emit(**line, same_homographies_witness_bf16_vs_float32=witness)
            check(0 < witness and same_err <= witness,
                  f"sweep_paths: the card's bf16 mxu warp differs from the "
                  f"CPU's by {same_err}, its witness {witness}")
        check(warp_err <= 2 * warp_ulp and var_err <= 2 * var_ulp,
              f"sweep_paths {label}: the card's mxu sweep differs from the "
              f"CPU's by {warp_err} (warped) and {var_err} (variance), more "
              f"than twice the one-ulp witnesses {warp_ulp} and {var_ulp}")
        del warp_card, warp_cpu, var_card, var_cpu, same, ulp, src, homos

        # one sweep chunk, forward and forward + backward
        chunk = torch.arange(model.sweep_chunk, device="cuda")
        leaf = feats.detach().requires_grad_()
        for method in ("mxu", "gather"):
            fn = sweeps[method]
            args = (proj44, chunk, nb[chunk], depths)
            cot = torch.randn((len(chunk), len(depths)) + feats.shape[1:],
                              device="cuda", generator=torch.Generator(
                                  "cuda").manual_seed(0))

            def forward():
                with torch.no_grad():
                    fn(feats, *args, compute_dtype=dtype)

            def forward_backward():
                fn(leaf, *args, compute_dtype=dtype).backward(cot)

            torch.cuda.reset_peak_memory_stats()
            emit(phase="sweep_paths", dtype=label, sweep=method,
                 chunk_refs=len(chunk), chunk_forward_ms=cuda_ms(
                     forward, reps=5, trials=3),
                 chunk_forward_backward_ms=cuda_ms(forward_backward, reps=3,
                                                   trials=3),
                 chunk_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            del cot
        del leaf, feats

        # the steady predict and step with each sweep, the same weights
        predict = make_predict_fn(model)
        for method in ("mxu", "gather"):
            model.sweep_method = method
            torch.cuda.reset_peak_memory_stats()
            times = []
            for sc in predict_scenes:
                t0 = time.perf_counter()
                predict(sc)
                times.append((time.perf_counter() - t0) * 1e3)
            emit(phase="sweep_paths", dtype=label, sweep=method,
                 predict_views=predict_scenes[0]["images"].shape[0],
                 predict_ms=times, steady_predict_ms=statistics.mean(
                     times[1:]),
                 predict_peak_memory_gb=torch.cuda.max_memory_allocated()
                 / 1e9)
        del model, predict
        step_times(cfg, dtype, dtype=label)
    # BatchNorm mode: one sweep chunk of all 40 views, no checkpoint
    step_times(dataclasses.replace(cfg, model=dataclasses.replace(
        mc, cost_reg_norm="batch")), torch.float32, dtype="float32",
        cost_reg_norm="batch")


def _overfit_worker(index, mode, jobs, out):
    """Run ``jobs`` ((case index, seed) pairs) one after another in this
    process in ``mode`` with `overfit_map.run`, counting the kernels each
    run's training steps launch (through `step_fn`) apart from those of
    its evaluations; the results go to ``<out>/overfit-<mode>-<index>.json``."""
    import os

    from mvsdet_torch.tools import overfit_map

    if mode == "deterministic":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        _deterministic(True)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = _launch_counts()
    results = []
    for case_index, seed in jobs:
        name, dtype, kwargs, _, _ = OVERFIT_CASES[case_index]
        stepped = {"launches": {}, "bf16_launches": {}, "head_dtypes": []}

        def counting_step_fn(state, plain=overfit_map.step_fn):
            step = plain(state)

            # the dtypes of the head's outputs, as a check that the run
            # computed in the case's dtype
            def head_dtype(mod, args, out):
                if not stepped["head_dtypes"]:
                    stepped["head_dtypes"] = sorted(
                        {str(x.dtype) for level in out for x in level})

            state.model.head.register_forward_hook(head_dtype)

            def counted(batch):
                before = _read_launches(fns)
                metrics = step(batch)
                for key, a, b in zip(("launches", "bf16_launches"), before,
                                     _read_launches(fns)):
                    for k in b:
                        stepped[key][k] = stepped[key].get(k, 0) + b[k] - a[k]
                return metrics
            return counted

        records = []
        _reset_launches(fns)
        t0 = time.perf_counter()
        with mock.patch.object(overfit_map, "step_fn", counting_step_fn):
            history = overfit_map.run(
                n_scenes=OVERFIT_SCENES, lr=1e-3, seed=seed,
                log_fn=records.append, device="cuda",
                dtype=getattr(torch, dtype), **kwargs)
        seconds = time.perf_counter() - t0
        launches, bf16_launches = _read_launches(fns)
        results.append(dict(
            case=case_index, seed=seed, mode=mode, history=history,
            seconds=seconds,
            losses=[json.loads(r) for r in records if '"loss"' in r],
            step_launches=stepped["launches"],
            step_bf16_launches=stepped["bf16_launches"],
            head_dtypes=stepped["head_dtypes"],
            eval_launches={k: v - stepped["launches"].get(k, 0)
                           for k, v in launches.items()},
            eval_bf16_launches={k: v - stepped["bf16_launches"].get(k, 0)
                                for k, v in bf16_launches.items()}))
    with open(Path(out) / f"overfit-{mode}-{index}.json", "w") as f:
        json.dump(results, f)


def _overfit_run_faults(r, name, dtype, kwargs, n_evals):
    """What one run got wrong: (its learning: the start or the drawdown;
    its path: the launches or the compute dtype)."""
    faults, path_faults = [], []
    tag = f"{name} {dtype} seed {r['seed']} ({r['mode']})"
    hist = r["history"]
    first, final = hist[0], hist[-1]
    best = max(h["mAP_0.25"] for h in hist)
    if first["mAP_0.25"] >= 0.3:
        faults.append(f"{tag}: starts at {first['mAP_0.25']}")
    if final["mAP_0.25"] < best - 0.2:
        faults.append(f"{tag}: final {final['mAP_0.25']} below its best "
                      f"{best} by more than 0.2")
    steps = kwargs["steps"]
    mvsdet = kwargs.get("model_family", "mvsdet") == "mvsdet"
    bf16 = dtype == "bfloat16"
    want_steps = {k: steps if mvsdet else 0 for k in r["step_launches"]}
    want_steps_bf16 = {k: steps if mvsdet and bf16 else 0
                       for k in r["step_bf16_launches"]}
    per_eval = {"composite_tiles", "weighted_gather_sum"}
    want_eval = {k: n_evals * OVERFIT_SCENES if mvsdet and k in per_eval
                 else 0 for k in r["eval_launches"]}
    want_eval_bf16 = {k: n_evals * OVERFIT_SCENES
                      if mvsdet and bf16 and k in per_eval else 0
                      for k in r["eval_bf16_launches"]}
    if (r["step_launches"], r["step_bf16_launches"], r["eval_launches"],
            r["eval_bf16_launches"]) != (want_steps, want_steps_bf16,
                                         want_eval, want_eval_bf16):
        path_faults.append(f"{tag}: launches {r['step_launches']}, bf16 "
                      f"{r['step_bf16_launches']} in the steps, "
                      f"{r['eval_launches']}, bf16 "
                      f"{r['eval_bf16_launches']} in the evaluations")
    # a bf16 head gives bf16 logits beside its float32 box sizes
    want_dtypes = sorted({"torch.float32", f"torch.{dtype}"})
    if r["head_dtypes"] != want_dtypes:
        path_faults.append(f"{tag}: the head's outputs in "
                           f"{r['head_dtypes']}, not {want_dtypes}")
    return faults, path_faults


def _overfit_jobs(mode):
    """Each worker's ((case index, seed), ...) in ``mode``: the longest
    run to the least loaded worker first, a run's cost its steps."""
    runs = sorted(((c, s) for c, case in enumerate(OVERFIT_CASES)
                   for s in OVERFIT_SEEDS
                   if mode == "deterministic"
                   or case[2].get("model_family", "mvsdet") == "mvsdet"),
                  key=lambda j: -OVERFIT_CASES[j[0]][2]["steps"])
    jobs = [[] for _ in range(OVERFIT_MODES[mode])]
    load = [0] * len(jobs)
    for job in runs:
        i = load.index(min(load))
        jobs[i].append(job)
        load[i] += OVERFIT_CASES[job[0]][2]["steps"]
    return jobs


def overfit_phase(timeout=900):
    """`overfit_map`: the cases of OVERFIT_CASES over OVERFIT_SEEDS, at
    JAX's steps and evaluation cadence on 2 synthetic scenes, from the
    JAX package's initial weights for each seed (`overfit_map.run`), in
    each of OVERFIT_MODES, spread over its processes on the card.  Each seed's history goes on a line of its own.
    The gate, JAX's learning tests' on three seeds, on the deterministic
    runs: every seed starts below 0.3 and ends within 0.2 of its own best;
    the median over the seeds of the final mAP_0.25 and of the final
    mAR_0.25 clears the case's gate.  The default-mode runs are held to
    the same gate and their verdict reported beside it, not failed on.
    In both modes each MVSDet training step launches K1-K5 and the index
    once (the bf16 runs K3-K5's bf16 variants), each evaluation K1 and K3
    once a scene and nothing else; NeRF-Det launches none; the head
    computes in the case's dtype.  Returns the failures (`main` fails on
    them after the kernels line)."""
    import torch.multiprocessing as mp

    out = Path(__file__).resolve().parent / "build" / "overfit"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn = mp.get_context("spawn")
    workers = [spawn.Process(target=_overfit_worker,
                             args=(i, mode, jobs, str(out)))
               for mode in OVERFIT_MODES
               for i, jobs in enumerate(_overfit_jobs(mode))]
    for w in workers:
        w.start()
    deadline = time.monotonic() + timeout
    for w in workers:
        w.join(max(deadline - time.monotonic(), 1.0))
    late = [w for w in workers if w.is_alive()]
    for w in late:
        w.kill()
        w.join()
    check(not late, f"overfit_map: {len(late)} workers did not finish in "
                    f"{timeout} s")
    check(all(w.exitcode == 0 for w in workers),
          f"overfit_map: worker exit codes {[w.exitcode for w in workers]}")
    wall = time.perf_counter() - t0
    results = []
    for mode, n_workers in OVERFIT_MODES.items():
        for i in range(n_workers):
            with open(out / f"overfit-{mode}-{i}.json") as f:
                results.extend(json.load(f))

    failures = []
    summary = []
    for c, (name, dtype, kwargs, gate_map, gate_mar) in \
            enumerate(OVERFIT_CASES):
        for mode in OVERFIT_MODES:
            runs = sorted((r for r in results
                           if r["case"] == c and r["mode"] == mode),
                          key=lambda r: r["seed"])
            if not runs:
                continue
            n_evals = len(runs[0]["history"])
            faults, path_faults = [], []
            for r in runs:
                emit(phase="overfit_map", case=name, dtype=dtype,
                     mode=mode, seed=r["seed"], steps=kwargs["steps"],
                     seconds=r["seconds"], history=r["history"],
                     losses=r["losses"], step_launches=r["step_launches"],
                     step_bf16_launches=r["step_bf16_launches"],
                     eval_launches=r["eval_launches"],
                     eval_bf16_launches=r["eval_bf16_launches"],
                     head_dtypes=r["head_dtypes"])
                learning, path = _overfit_run_faults(r, name, dtype, kwargs,
                                                     n_evals)
                faults += learning
                path_faults += path
            finals = [r["history"][-1] for r in runs]
            med_map = statistics.median(f["mAP_0.25"] for f in finals)
            med_mar = statistics.median(f["mAR_0.25"] for f in finals)
            if not (med_map > gate_map and med_mar > gate_mar):
                faults.append(f"{name} {dtype} ({mode}): median final "
                              f"mAP_0.25 {med_map}, mAR_0.25 {med_mar}, "
                              f"gate > {gate_map}, > {gate_mar}")
            # the path fails in either mode, the learning in the
            # deterministic mode alone
            failures += path_faults + (faults if mode == "deterministic"
                                       else [])
            summary.append(dict(
                case=name, dtype=dtype, mode=mode, steps=kwargs["steps"],
                eval_every=kwargs["eval_every"], seeds=list(OVERFIT_SEEDS),
                final_map_025=[f["mAP_0.25"] for f in finals],
                final_mar_025=[f["mAR_0.25"] for f in finals],
                median_map_025=med_map, median_mar_025=med_mar,
                gate_map_025=gate_map, gate_mar_025=gate_mar,
                gate_held=not faults, faults=faults + path_faults,
                seconds=[r["seconds"] for r in runs]))
    emit(phase="overfit_map", workers=len(workers), wall_s=wall,
         cases=summary, failures=failures)
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--save-kernel-inputs", metavar="PATH",
        help="also torch.save the inputs the training step and the predict "
             "gave K1-K5, the bf16 step K3, K4 and K5 and the bf16 predict "
             "K3 (for mvsdet_torch/tools/time_kernels.py)")
    parser.add_argument(
        "--launch-rank", metavar="DIR",
        help="run as one torchrun process of launch_train_parallel: the "
             "train launcher with the arguments that follow, then this "
             "rank's launch counts into DIR")
    opts, launcher_args = parser.parse_known_args(argv)
    if launcher_args and not opts.launch_rank:
        parser.error(f"unrecognized arguments: {' '.join(launcher_args)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "mvsdet_torch").is_dir():
        print("chip_smoke: run from the root of the repository (the "
              "mvsdet_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if opts.launch_rank:
        launch_rank(opts.launch_rank, launcher_args)
        return 0

    from mvsdet_torch.config import arkit_config, scannet_config
    from mvsdet_torch.data.synthetic import make_synthetic_scene
    from mvsdet_torch.evaluation import harness
    from mvsdet_torch.evaluation.harness import make_predict_fn
    from mvsdet_torch.evaluation.indoor_eval import indoor_map
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
    from mvsdet_torch.tools import test as test_launcher
    from mvsdet_torch.tools import train as train_launcher
    from mvsdet_torch.training.loop import (create_predict_state,
                                            create_train_state, fit)

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
        composite_tiles.c1_launches = 0

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

    # the one-channel compositor of the predict's rendered depth
    data, vals = random_tables(80, 2048, 1, g)
    got = composite_tiles(data, vals, 10)
    err = (got - composite_tiles_reference(data, vals, 10)).abs().max().item()
    same = torch.equal(got, composite_tiles(data, vals, 10))
    emit(phase="K1_c1", tiles=80, k=2048, c=1, max_abs_err=err,
         bit_equal_relaunch=same,
         ms=cuda_ms(lambda: composite_tiles(data, vals, 10)),
         plain_ms=cuda_ms(lambda: composite_tiles_reference(data, vals, 10),
                          reps=3))
    check(err <= 1e-4, f"K1 at C=1: max abs error {err} > 1e-4")
    check(same, "K1 at C=1: two launches differ")

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

    def diagnostics_phases(cfg, scenes, dtype):
        """`diagnostics`: each scene through make_predict_fn with the
        diagnostics, the launch counts set to 0 just before and read just
        after (K1 twice a scene, once with one channel for the rendered
        depth, K3 once, the backward kernels never); the outputs' shapes
        and ranges; the steady predict time without and with them.  Then
        `diagnostics_vs_plain`: the first scene with the kernels against
        it with the plain versions.  Returns the launches, the one-channel
        K1 launches and that K1 launch's inputs."""
        label = str(dtype).replace("torch.", "")
        mc = cfg.model
        n_scenes = len(scenes)
        model = build_model(cfg, device="cuda", dtype=dtype,
                            generator=torch.Generator().manual_seed(cfg.seed))
        predict = make_predict_fn(model, diagnostics=True)
        plain_predict = make_predict_fn(model)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        preds, latency = [], []
        for scene in scenes:
            t0 = time.perf_counter()
            preds.append(predict(scene))
            latency.append((time.perf_counter() - t0) * 1e3)
        launches, bf16_launches = read_launches()
        c1 = composite_tiles.c1_launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_launches(
            launches, bf16_launches,
            {name: {"composite_tiles": 2 * n_scenes,
                    "weighted_gather_sum": n_scenes}.get(name, 0)
             for name in launches},
            {name: n_scenes if (name == "weighted_gather_sum"
                                and dtype == bf16) else 0
             for name in bf16_launches}, f"{n_scenes} {label} diagnostics")
        check(c1 == n_scenes, f"{label} diagnostics: {c1} one-channel K1 "
                              f"launches, expected {n_scenes}")
        far = mc.near_far_range[1]
        gs_keys = ("gs_means", "gs_covariances", "gs_harmonics",
                   "gs_opacities")
        for pred in preds:
            depth = pred["rendered_depth"]
            check(depth.shape == (1,) + mc.target_size
                  and depth.dtype == np.float32,
                  f"rendered_depth: {depth.dtype} {depth.shape}")
            check(bool(np.all(np.isfinite(depth))) and depth.max() <= far + 1
                  and depth.max() > 0,
                  f"rendered_depth: max {depth.max()}, scene range {far}")
            check(0 <= float(pred["weight_gap"]) <= 1
                  and np.isfinite(pred["src_rmse"]),
                  f"weight_gap {pred['weight_gap']}, src_rmse "
                  f"{pred['src_rmse']}")
            g = pred["gs_means"].shape[0]
            check(all(pred[k].shape[0] == g
                      and np.all(np.isfinite(pred[k])) for k in gs_keys),
                  f"the Gaussians' arrays: "
                  f"{[pred[k].shape for k in gs_keys]}")
        # steady state: the scenes after the first, each without and with
        steady = {"plain": [], "diagnostics": []}
        for scene in scenes[1:]:
            for name, fn in (("plain", plain_predict),
                             ("diagnostics", predict)):
                t0 = time.perf_counter()
                fn(scene)
                steady[name].append((time.perf_counter() - t0) * 1e3)
        emit(phase="diagnostics", dtype=label, scenes=n_scenes,
             views=cfg.data.n_src_test, latency_ms=latency,
             steady_plain_ms=steady["plain"],
             steady_diagnostics_ms=steady["diagnostics"],
             launches=launches, bf16_launches=bf16_launches,
             c1_launches=c1, peak_memory_gb=peak,
             gaussians=int(preds[0]["gs_means"].shape[0]),
             gs_host_mb=sum(preds[0][k].nbytes for k in gs_keys) / 1e6,
             rendered_depth_max=[float(p["rendered_depth"].max())
                                 for p in preds],
             weight_gap=[float(p["weight_gap"]) for p in preds],
             src_rmse=[float(p["src_rmse"]) for p in preds])

        # the first scene with the plain versions in place of the kernels
        torch.backends.cudnn.deterministic = True
        runs = {}
        for run, lift_fn, comp_fn in (
                ("kernel", weighted_gather_sum, composite_tiles),
                ("plain", weighted_gather_sum_reference,
                 composite_tiles_reference)):
            comp = Recorder(comp_fn, keep=lambda args: args[1].shape[1] == 1)
            with mock.patch.object(voxel_lift, "weighted_gather_sum",
                                   lift_fn), \
                    mock.patch.object(splat_tiles, "composite_tiles", comp):
                runs[run] = (predict(scenes[0]), comp)
        (pk, ck), (pp, _) = runs["kernel"], runs["plain"]
        depth_err = float(np.abs(pk["rendered_depth"]
                                 - pp["rendered_depth"]).max())
        depth_tol = 1e-4 * float(np.abs(pp["rendered_depth"]).max())
        lift_rel = {k: abs(float(pk[k]) - float(pp[k])) / abs(float(pp[k]))
                    for k in ("weight_gap", "src_rmse")}
        gs_err = {k: float(np.abs(pk[k] - pp[k]).max()) for k in gs_keys}
        gs_equal = all(np.allclose(pk[k], pp[k], rtol=1e-5, atol=1e-5)
                       for k in gs_keys)
        emit(phase="diagnostics_vs_plain", dtype=label,
             rendered_depth_max_abs_err=depth_err,
             rendered_depth_tol=depth_tol, lift_rel_err=lift_rel,
             gs_max_abs_err=gs_err)
        check(depth_err <= depth_tol,
              f"diagnostics {label}: rendered_depth differs by {depth_err} "
              f"> {depth_tol}")
        check(max(lift_rel.values()) <= 1e-5,
              f"diagnostics {label}: weight_gap/src_rmse differ: {lift_rel}")
        check(gs_equal, f"diagnostics {label}: the Gaussians differ: "
                        f"{gs_err}")
        k1_c1_args = detached(ck.args)
        check(k1_c1_args[1].shape[1] == 1, "the depth's K1 launch was not "
                                           "recorded")
        torch.backends.cudnn.deterministic = False
        del model, predict, plain_predict, preds, runs, pk, pp, ck
        torch.cuda.empty_cache()
        return launches, c1, k1_c1_args

    def dense_vs_tiled_phase(cfg):
        """`dense_vs_tiled`: the Gaussians `scannet_config()` predicts from
        DENSE_SOURCE_VIEWS source views (one target, each of its
        DENSE_SOURCE_VIEWS nearest views rendered) through the dense
        `render_view`, colour and depth, against `render_view_tiled`
        binning every Gaussian into every tile (capacity G, so K1 sees
        each pair the dense renderer sees and culls by its own exact
        alpha boxes): within 1e-3 max abs.  The dense renderer's time and
        peak memory, forward alone and, for the colour, with its
        backward."""
        from mvsdet_torch.ops.splat import render_view
        from mvsdet_torch.ops.splat_tiles import render_view_tiled
        mc = cfg.model
        cfg8 = dataclasses.replace(cfg, model=dataclasses.replace(
            mc, gs=dataclasses.replace(
                mc.gs, render_src_per_target=DENSE_SOURCE_VIEWS)))
        scene = make_synthetic_scene(cfg8, seed=0,
                                     n_views=DENSE_SOURCE_VIEWS + 1,
                                     n_targets=1)
        model = build_model(cfg8, device="cuda",
                            generator=torch.Generator().manual_seed(cfg.seed))
        batch = {k: torch.as_tensor(v).cuda() for k, v in scene.items()}
        with torch.no_grad():
            gs = model(batch)["gaussians"]
            k = model._target_intrinsics(batch, mc.target_size)[0]
        c2w = batch["tgt_c2w"][0]
        n_gs = gs.means.shape[0]
        check(n_gs == DENSE_SOURCE_VIEWS * mc.feature_size[0]
              * mc.feature_size[1], f"dense_vs_tiled: {n_gs} Gaussians")
        w2c = torch.linalg.inv(c2w)
        z = (gs.means @ w2c[2, :3] + w2c[2, 3])[:, None]
        bg = torch.tensor(mc.gs.background_color, device="cuda")
        args = (gs.means, gs.covariances, gs.harmonics, gs.opacities, c2w, k,
                mc.target_size)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            dense = (render_view(*args, background=bg),
                     render_view(*args, value_override=z))
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9

        # one backward of the dense colour render, as a training step
        # would take it: every chunk's intermediates kept
        leaves = [a.detach().requires_grad_() for a in args[:4]]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        render_view(*leaves, *args[4:], background=bg).square().sum() \
            .backward()
        torch.cuda.synchronize()
        backward_s = time.perf_counter() - t0
        backward_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        grads_finite = all(bool(torch.isfinite(a.grad).all())
                           for a in leaves)
        del leaves
        # every Gaussian in every tile's bin: only K1's cull boxes remain
        capacity = -(-n_gs // 128) * 128
        with mock.patch.object(splat_tiles, "splat_radii",
                               lambda cov: torch.full_like(cov[:, 0], 1e9)), \
                torch.no_grad():
            tiled = (render_view_tiled(*args, background=bg,
                                       capacity=capacity),
                     render_view_tiled(*args, capacity=capacity,
                                       value_override=z))
        unbinned = [(x - y).abs().max().item() for x, y in zip(dense, tiled)]
        emit(phase="dense_vs_tiled", source_views=DENSE_SOURCE_VIEWS,
             gaussians=n_gs, image=list(mc.target_size),
             rgb_max_abs_err=unbinned[0], depth_max_abs_err=unbinned[1],
             depth_max=dense[1].max().item(), dense_s=dense_s,
             dense_peak_gb_over_inputs=peak,
             dense_colour_forward_backward_s=backward_s,
             dense_colour_backward_peak_gb_over_inputs=backward_peak)
        check(dense[1].max().item() > 0, "dense_vs_tiled: no depth")
        check(grads_finite, "dense_vs_tiled: the dense render's gradients "
                            "are not finite")
        check(max(unbinned) <= 1e-3,
              f"dense_vs_tiled: colour differs by {unbinned[0]}, depth by "
              f"{unbinned[1]} > 1e-3")
        del model, batch, gs, args, dense, tiled, z
        torch.cuda.empty_cache()

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

    def launch_phases():
        """The launchers as a user runs them, in process: `train` for
        LAUNCH_STEPS bf16 steps on two synthetic scenes (an epoch of two
        steps, each epoch ending in a save and an evaluation of one 80-view
        scene), then `test` from its `best` checkpoint on N_SCENES scenes,
        against the same with the plain versions, and `test --arkit` in
        bf16.  Each is driven with the launch counts set to 0 just before
        and read just after."""
        work = Path(__file__).resolve().parent / "build" / "launch"
        shutil.rmtree(work, ignore_errors=True)
        reset_launches()
        state = train_launcher.main([
            "--synthetic", "2", "--steps", str(LAUNCH_STEPS),
            "--val-synthetic", "1", "--dtype", "bfloat16", "--log-every", "1",
            "--work-dir", str(work)])
        launches, bf16_launches = read_launches()
        with open(work / "train_log.jsonl") as f:
            log = [json.loads(line) for line in f]
        steps = [r for r in log if "loss" in r]
        evals = [r["eval"] for r in log if "eval" in r]
        saves = [r for r in log if "saved" in r]
        # a step's time: from the end of the record before it, where that
        # is a step too (an evaluation or a save lies between the others)
        step_ms = [(b["time"] - a["time"]) * 1e3
                   for a, b in zip(log, log[1:]) if "loss" in a and "loss" in b]
        n_evals = LAUNCH_STEPS // 2
        emit(phase="launch_train", dtype="bfloat16", steps=len(steps),
             views=cfg.data.n_src_train,
             targets=cfg.data.nerf_target_views_train,
             first_step_ms=steps[0]["time"] * 1e3, steady_step_ms=step_ms,
             eval_predict_s=[e["predict_s_first"] for e in evals],
             eval_map_025=[e["mAP_0.25"] for e in evals],
             save_s={f"{r['saved']}@{r['step']}": r["save_s"] for r in saves},
             losses=[r["loss"] for r in steps], launches=launches,
             bf16_launches=bf16_launches)
        check(len(steps) == LAUNCH_STEPS and all(
            np.isfinite(v) for r in steps for v in r.values()),
              f"launch_train: step records {steps}")
        check(len(evals) == n_evals and all("mAP_0.25" in e for e in evals),
              f"launch_train: evaluations {evals}")
        check((work / "latest").is_file() and (work / "best").is_file(),
              "launch_train: latest or best was not written")
        check(state.step == LAUNCH_STEPS, f"launch_train: at step {state.step}")
        # each step launches every kernel once; each evaluation's predict
        # K1 and K3 once (bf16: K3, K4 and K5 as their bf16 variants)
        per_eval = ("composite_tiles", "weighted_gather_sum")
        check_launches(
            launches, bf16_launches,
            {name: LAUNCH_STEPS + n_evals * (name in per_eval)
             for name in launches},
            {"weighted_gather_sum": LAUNCH_STEPS + n_evals,
             "weighted_gather_sum_dfeat": LAUNCH_STEPS,
             "weighted_gather_sum_dweight": LAUNCH_STEPS},
            "launch_train")
        del state
        torch.cuda.empty_cache()

        # -- test from `best`: the trained weights, the kernels' metrics
        # against the plain versions' --------------------------------------
        argv = ["--synthetic", str(N_SCENES), "--checkpoint",
                str(work / "best")]
        models = []

        def recording_state(*args, **kwargs):
            models.append(create_predict_state(*args, **kwargs))
            return models[-1]

        reset_launches()
        with mock.patch.object(test_launcher, "create_predict_state",
                               recording_state):
            results = test_launcher.main(argv)
        launches, bf16_launches = read_launches()
        name = "head.conv_cls.weight"
        best = torch.load(work / "best", map_location="cuda",
                          weights_only=True)["model"][name]
        loaded = models[0].state_dict()[name]
        untrained = build_model(cfg, device="cuda").state_dict()[name]
        emit(phase="launch_test", dtype="float32", scenes=N_SCENES,
             views=cfg.data.n_src_test, results=results, launches=launches,
             bf16_launches=bf16_launches,
             trained_weights_loaded=torch.equal(loaded, best),
             weights_moved_in_training=not torch.equal(best, untrained))
        check(torch.equal(loaded, best) and not torch.equal(best, untrained),
              f"launch_test: {name} is not the trained one")
        keys = {"mAP_0.25", "mAP_0.50", "psnr", "ssim", "predict_s_first",
                "predict_s_per_scene"}
        check(keys <= set(results), f"launch_test: missing "
                                    f"{keys - set(results)}")
        check_launches(launches, bf16_launches,
                       {name: N_SCENES * (name in per_eval)
                        for name in launches},
                       {name: 0 for name in bf16_launches}, "launch_test")

        # -- again with --diagnostics --vis-dir: the depth metrics, and the
        # images and the PLY of each scene, the hook timed ------------------
        vis = work.parent / "vis"
        shutil.rmtree(vis, ignore_errors=True)
        hook_s = []
        make_vis_hook = test_launcher.make_vis_hook

        def timed_vis_hook(*args):
            hook = make_vis_hook(*args)

            def timed(*scene):
                t0 = time.perf_counter()
                hook(*scene)
                hook_s.append(time.perf_counter() - t0)
            return timed

        reset_launches()
        with mock.patch.object(test_launcher, "make_vis_hook",
                               timed_vis_hook):
            results = test_launcher.main(argv + ["--diagnostics",
                                                 "--vis-dir", str(vis)])
        launches, bf16_launches = read_launches()
        c1 = composite_tiles.c1_launches
        vis_files = ["boxes_0.png", "boxes_1.png", "boxes_2.png",
                     "render_0.png", "gt_0.png", "render_depth_0.png",
                     "src_depth_0.png", "src_depth_1.png", "src_depth_2.png"]
        missing, vertices = [], []
        for si in range(N_SCENES):
            d = vis / f"scene{si:04d}"
            missing += [f"{d.name}/{f}" for f in vis_files
                        if not (d / f).is_file()
                        or (d / f).read_bytes()[:4] != b"\x89PNG"]
            ply = d / "gaussians.ply"
            header = ply.read_bytes()[:1024].split(b"end_header")[0] \
                if ply.is_file() else b""
            vertices.append(int(header.split(b"element vertex ")[1]
                                .split()[0]) if header else 0)
        emit(phase="launch_test", dtype="float32", scenes=N_SCENES,
             diagnostics=True, results=results, launches=launches,
             bf16_launches=bf16_launches, c1_launches=c1,
             vis_hook_s=hook_s, ply_vertices=vertices,
             missing_files=missing)
        check(all(np.isfinite(results.get(k, np.nan))
                  for k in DIAGNOSTICS_METRICS) and keys <= set(results),
              f"launch_test --diagnostics: metrics {results}")
        check(not missing and len(hook_s) == N_SCENES,
              f"launch_test --vis-dir: missing {missing}, hooks {hook_s}")
        check(min(vertices) > 0, f"launch_test --vis-dir: PLY vertices "
                                 f"{vertices}")
        check_launches(launches, bf16_launches,
                       {name: {"composite_tiles": 2 * N_SCENES,
                               "weighted_gather_sum": N_SCENES}.get(name, 0)
                        for name in launches},
                       {name: 0 for name in bf16_launches},
                       "launch_test --diagnostics")
        check(c1 == N_SCENES, f"launch_test --diagnostics: {c1} "
                              f"one-channel K1 launches")
        # the same evaluations, without and with --diagnostics, with the
        # kernels and with the plain versions, cuDNN deterministic, as
        # `predict_vs_plain` swaps them, from a head fitted to detect these
        # scenes
        argv = ["--synthetic", str(N_SCENES), "--checkpoint",
                str(work / "detecting")]
        tuned, fit = detecting_head(models[0], cfg)
        torch.save({"model": tuned}, work / "detecting")
        del tuned
        detecting = (work / "detecting", {}, {})
        for diagnostics in (False, True):
            tag = "launch_test" + " --diagnostics" * diagnostics
            runs, scored = {}, {}
            torch.backends.cudnn.deterministic = True
            for run, lift_fn, comp_fn in (
                    ("kernel", weighted_gather_sum, composite_tiles),
                    ("plain", weighted_gather_sum_reference,
                     composite_tiles_reference)):
                def scoring_map(preds, gts, run=run, **kwargs):
                    scored[run] = preds
                    return indoor_map(preds, gts, **kwargs)

                with mock.patch.object(voxel_lift, "weighted_gather_sum",
                                       lift_fn), \
                        mock.patch.object(splat_tiles, "composite_tiles",
                                          comp_fn), \
                        mock.patch.object(harness, "indoor_map",
                                          scoring_map):
                    runs[run] = test_launcher.main(
                        argv + ["--diagnostics"] * diagnostics)
            torch.backends.cudnn.deterministic = False
            kernel, plain = runs["kernel"], runs["plain"]
            aps = sorted(k for k in plain
                         if k.startswith(("AP_", "mAP", "mAR")))
            ap_equal = set(kernel) == set(plain) and all(
                kernel[k] == plain[k] for k in aps)
            nvs_rel = {k: abs(kernel[k] - plain[k]) / abs(plain[k])
                       for k in ("psnr", "ssim")}
            diag_rel = {k: abs(kernel[k] - plain[k]) / abs(plain[k])
                        for k in DIAGNOSTICS_METRICS if diagnostics}
            # the boxes, scores and labels the mAP was given, scene by scene
            pairs = list(zip(scored["kernel"], scored["plain"]))
            preds_equal = len(pairs) == N_SCENES and all(
                np.array_equal(a["labels"], b["labels"])
                and np.allclose(a["boxes"], b["boxes"], rtol=1e-5, atol=1e-5)
                and np.allclose(a["scores"], b["scores"], rtol=1e-5,
                                atol=1e-5)
                for a, b in pairs)
            emit(phase="launch_test_vs_plain", diagnostics=diagnostics,
                 aps_equal=ap_equal, nvs_rel_err=nvs_rel,
                 diagnostics_rel_err=diag_rel,
                 kernel={k: kernel[k] for k in aps[-4:]},
                 plain={k: plain[k] for k in aps[-4:]},
                 boxes_per_scene=[len(b["labels"]) for _, b in pairs],
                 preds_equal=preds_equal, head_fit=fit)
            check(preds_equal, f"{tag}: the boxes, scores or labels given "
                               f"to the mAP differ from the plain versions' "
                               f"(1e-5)")
            check(plain["mAP_0.25"] > 0, f"{tag}: the tuned head detects "
                                         f"nothing ({plain}), so the APs' "
                                         f"equality would hold trivially")
            check(ap_equal, f"{tag}: APs differ from the plain versions': "
                            f"{kernel} against {plain}")
            check(max(nvs_rel.values()) <= 1e-4,
                  f"{tag}: psnr/ssim differ from the plain versions' by "
                  f"{nvs_rel}")
            # the rendered depth to 1e-4, the lift's diagnostics to 1e-5, as
            # `diagnostics_vs_plain` holds them
            check(not diagnostics or (
                diag_rel["depth_rmse"] <= 1e-4
                and max(diag_rel["weight_gap"], diag_rel["src_rmse"])
                <= 1e-5),
                  f"{tag}: the diagnostics differ from the plain "
                  f"versions' by {diag_rel}")
            run = "diagnostics" if diagnostics else "predict"
            detecting[1][run], detecting[2][run] = kernel, scored["kernel"]

        # -- test --arkit in bf16: the rotated mAP ----------------------------
        arkit_dims = []

        def recording_map(preds, gts, **kwargs):
            arkit_dims.extend(p["boxes"].shape[-1] for p in preds + gts)
            return indoor_map(preds, gts, **kwargs)

        reset_launches()
        with mock.patch.object(harness, "indoor_map", recording_map):
            results = test_launcher.main(["--arkit", "--synthetic", "2",
                                          "--dtype", "bfloat16"])
        launches, bf16_launches = read_launches()
        emit(phase="launch_test", config="arkit", dtype="bfloat16", scenes=2,
             views=arkit.data.n_src_test, results=results,
             box_dims=sorted(set(arkit_dims)), launches=launches,
             bf16_launches=bf16_launches)
        check(keys <= set(results), f"launch_test --arkit: missing "
                                    f"{keys - set(results)}")
        check(set(arkit_dims) == {7}, f"launch_test --arkit: boxes of "
                                      f"{set(arkit_dims)} dims reached the mAP")
        check_launches(launches, bf16_launches,
                       {name: 2 * (name in per_eval) for name in launches},
                       {name: 2 * (name == "weighted_gather_sum")
                        for name in bf16_launches}, "launch_test --arkit")
        del models
        torch.cuda.empty_cache()
        return detecting

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
    diag_launches, diag_c1_launches, k1_c1_args = diagnostics_phases(
        cfg, scenes, torch.float32)
    diagnostics_phases(cfg, scenes, bf16)
    dense_vs_tiled_phase(cfg)

    scene = make_synthetic_scene(cfg, seed=0, n_views=cfg.data.n_src_train,
                                 n_targets=cfg.data.nerf_target_views_train)
    train_launches, _, recorders, grads32, _ = train_phases(
        cfg, torch.float32, scene)
    _, train_bf16_launches, recorders_bf16, _, _ = train_phases(
        cfg, bf16, scene, grads32)
    sweep_paths_phase(cfg, scene, scenes)

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
    detecting = launch_phases()

    # -- data x view parallel: rank processes sharing the card -----------
    parallel_train_phase(cfg)
    parallel_predict_phase(detecting[0], N_SCENES, *detecting[1:])
    launch_train_parallel_phase()

    # -- the legacy NeRF-Det, in float32 and bf16 --------------------------
    for dtype in (torch.float32, bf16):
        nerfdet_phases(cfg, scene, reset_launches, read_launches, dtype)

    # -- the learning check: overfit_map over three seeds ------------------
    overfit_failures = overfit_phase()

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
    # K1 at C=1 on the tables the float32 diagnostics predict gave it
    cull_c1 = cull_check(k1_c1_args[0], k1_c1_args[2])
    emit(phase="cull", tables="diagnostics_depth",
         tiles=k1_c1_args[0].shape[0], k=k1_c1_args[0].shape[2], **cull_c1)
    check_cull(cull_c1, "diagnostics_depth")
    k1c1_err = (composite_tiles(*k1_c1_args) - composite_tiles_reference(
        *k1_c1_args)).abs().max().item()
    check(k1c1_err <= 1e-4, f"K1 at C=1 on the depth's tables: {k1c1_err}")
    k1c1_b, k1c1_by = k1_bound(k1_c1_args[0], k1_c1_args[1], cull_c1)
    k1c1_all, _ = k1_bound(k1_c1_args[0], k1_c1_args[1], cull_c1,
                           all_pairs=True)
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
        dict(name="composite_tiles_c1", route="cuda",
             source="mvsdet_torch/ops/csrc/composite_tiles.cu",
             replaces="mvsdet_tpu/ops/pallas/splat_kernel.py:48",
             launches=diag_c1_launches,
             predict_launches=diag_launches["composite_tiles"],
             max_abs_err=k1c1_err,
             ms=cuda_ms(lambda: composite_tiles(*k1_c1_args)),
             host_paced_ms=cuda_ms(lambda: composite_tiles(*k1_c1_args),
                                   queued=False),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(*k1_c1_args),
                              reps=3),
             bound_ms=k1c1_b, bound_by=k1c1_by, all_pairs_bound_ms=k1c1_all,
             library_ms=None,
             library_covers="none: no PyTorch call composites sorted splats",
             shape=dict(tiles=k1_c1_args[0].shape[0],
                        k=k1_c1_args[0].shape[2], c=k1_c1_args[1].shape[1])),
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
                    "k1_predict": k1_predict_args, "k1_c1": k1_c1_args,
                    "k3": k3_args,
                    "k3_predict": k3_predict_args, "k4": k4_args,
                    "k5": k5_args, "k3_bf16": k3b_args,
                    "k3_bf16_predict": k3b_predict_args, "k4_bf16": k4b_args,
                    "k5_bf16": k5b_args}, opts.save_kernel_inputs)
    print(json.dumps({"kernels": kernels}), flush=True)
    check(not overfit_failures, f"overfit_map: {overfit_failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
