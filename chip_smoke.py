#!/usr/bin/env python3
"""Drive the port's predict path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printed as one JSON line:

  device   the card's name and power limit (as nvidia-smi prints them, on
           a line of their own), torch and CUDA versions
  build    compile every kernel of the path from `mvsdet_torch/ops/csrc`
           for sm_90a, one nvcc per source, all started together
  K1       the tile compositor against its plain version on random tables
           at the predict (T=80) and training (T=160) shapes, K=2048, C=3,
           30% empty slots: max abs error <= 1e-4
  K3       the voxel-lift gather against its plain version and against
           F.embedding_bag at N=80, HW=4800, C=256, V=25600: max error
           <= 1e-5 of max |out|
  predict  `scannet_config()` at full width with random weights from a
           seeded generator, three synthetic scenes of 80 source views
           (240x320) and one target (120x160) through `make_predict_fn`,
           launch counts set to 0 just before and read just after;
           outputs finite and of the expected shapes; then one scene
           again with the plain versions in place of the kernels:
           rendered <= 1e-4, lifted volume <= 1e-5 relative, kept boxes
           and labels equal under the mask
  kernels  every kernel of the path with its launches in the predict run,
           its error, its time, its plain version's time, its bound and
           the time of one PyTorch call computing the same function, all
           at the inputs the predict run gave it

The last line is {"ok": true, "device": {...}}.  Any failed check raises,
and the script exits non-zero without that line.  TF32 is off throughout
(the JAX predict path runs in float32), and cuDNN is made deterministic
for the comparison with the plain versions.  Times come from CUDA events,
latencies from the host clock around work that ends in a copy to host.
"""

from __future__ import annotations

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


def random_tables(n_tiles: int, k: int, c: int, g: torch.Generator):
    """Tile tables in the compositor's layout, 30% of slots empty."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n_tiles, k, device="cuda",
                                           generator=g)
    data = torch.zeros(n_tiles, 8, k, device="cuda")
    data[:, 0], data[:, 1] = u(0, 160), u(0, 120 * n_tiles // 80)
    data[:, 2], data[:, 3], data[:, 4] = u(0.02, 0.3), u(-0.01, 0.01), \
        u(0.02, 0.3)
    data[:, 5] = u(0.0, 0.95) * (u(0, 1) >= 0.3)
    vals = torch.rand(n_tiles, c, k, device="cuda", generator=g)
    return data, vals


def k1_bound(data: torch.Tensor, vals: torch.Tensor, tiles_x: int):
    """Least time for the compositor on these inputs: each table read
    once and the output written once, against 12 flops per (pixel, slot)
    pair to find whether it is culled plus 2C + 3 (accumulation, exp,
    log1p, the transmittance exp) per pair that this data leaves active."""
    from mvsdet_torch.ops.splat_kernel import (ALPHA_MAX, ALPHA_MIN,
                                               PIXELS, _tile_pixel_coords)
    n_tiles, _, k = data.shape
    c = vals.shape[1]
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
    ops = 12 * n_tiles * PIXELS * k + (2 * c + 3) * active
    nbytes = 4 * (data.numel() + vals.numel() + n_tiles * (c + 1) * PIXELS)
    return bound(nbytes, ops)


def k3_bound(feat: torch.Tensor, pix: torch.Tensor, weight: torch.Tensor):
    """Least time for the gather on these inputs: the feature rows its
    nonzero weights select, read once, with pix and weight, and the
    output written once, against 2 flops per selected value."""
    n, hw, c = feat.shape
    nz = weight != 0
    rows = torch.unique((torch.arange(n, device=pix.device)[:, None] * hw
                         + pix.long())[nz]).numel()
    nbytes = 4 * (rows * c + 2 * pix.numel() + pix.shape[1] * c)
    return bound(nbytes, 2 * c * int(nz.sum()))


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


class Recorder:
    """Stands in for a kernel wrapper at its call site: calls `fn` and
    keeps the first call's inputs and output."""

    def __init__(self, fn):
        self.fn = fn
        self.args = self.out = None

    def __call__(self, *args):
        out = self.fn(*args)
        if self.args is None:
            self.args, self.out = args, out
        return out


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
    from mvsdet_torch.ops import build, splat_tiles, voxel_lift
    from mvsdet_torch.ops.lift_kernel import (weighted_gather_sum,
                                              weighted_gather_sum_reference)
    from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                               composite_tiles_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    libs = build.build(["composite_tiles", "weighted_gather_sum"])
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs.values()])

    g = torch.Generator(device="cuda").manual_seed(0)

    # -- K1 on random tables -------------------------------------------
    for n_tiles in (80, 160):
        data, vals = random_tables(n_tiles, 2048, 3, g)
        err = (composite_tiles(data, vals, 10)
               - composite_tiles_reference(data, vals, 10)).abs().max().item()
        emit(phase="K1", tiles=n_tiles, k=2048, c=3, max_abs_err=err,
             ms=cuda_ms(lambda: composite_tiles(data, vals, 10)),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(
                 data, vals, 10), reps=3))
        check(err <= 1e-4, f"K1 at T={n_tiles}: max abs error {err} > 1e-4")

    # -- K3 on random inputs -------------------------------------------
    n, hw, c, v = 80, 4800, 256, 25600
    feat = torch.rand(n, hw, c, device="cuda", generator=g)
    pix = torch.randint(0, hw, (n, v), device="cuda", generator=g,
                        dtype=torch.int32)
    weight = torch.rand(n, v, device="cuda", generator=g) \
        * (torch.rand(n, v, device="cuda", generator=g) < 0.3)
    ref = weighted_gather_sum_reference(feat, pix, weight)
    rel = ((weighted_gather_sum(feat, pix, weight) - ref).abs().max()
           / ref.abs().max()).item()
    emit(phase="K3", n=n, hw=hw, c=c, v=v, max_rel_err=rel,
         ms=cuda_ms(lambda: weighted_gather_sum(feat, pix, weight)),
         plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
             feat, pix, weight), reps=3),
         library_ms=cuda_ms(embedding_bag_fn(feat, pix, weight)))
    check(rel <= 1e-5, f"K3: relative error {rel} > 1e-5")
    del feat, pix, weight, ref

    # -- predict at full ScanNet width ---------------------------------
    cfg = scannet_config()
    mc = cfg.model
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    predict = make_predict_fn(model)
    scenes = [make_synthetic_scene(cfg, seed=s, n_views=cfg.data.n_src_test,
                                   n_targets=cfg.data.nerf_target_views_test)
              for s in range(N_SCENES)]
    counted = {"composite_tiles": composite_tiles,
               "weighted_gather_sum": weighted_gather_sum}
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    preds = []
    for s, scene in enumerate(scenes):
        t0 = time.perf_counter()
        preds.append(predict(scene))
        emit(phase="predict", scene=s, latency_ms=(time.perf_counter() - t0)
             * 1e3, kept_boxes=int(preds[-1]["mask"].sum()))
    launches = {name: fn.launches for name, fn in counted.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase="predict", scenes=N_SCENES, views=cfg.data.n_src_test,
         launches=launches, peak_memory_gb=peak_gb)
    for name, count in launches.items():
        check(count == N_SCENES, f"{name} launched {count} times in "
                                 f"{N_SCENES} predicts")
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
    vol_rel = ((lk.out - lp.out).abs().max() / lp.out.abs().max()).item()
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

    # -- kernels line, at the inputs the predict path gave them --------
    data, vals, tiles_x = ck.args
    feat, pix, weight = lk.args
    k1_err = (composite_tiles(data, vals, tiles_x)
              - composite_tiles_reference(data, vals, tiles_x)).abs().max()
    k3_ref = weighted_gather_sum_reference(feat, pix, weight)
    k3_err = (weighted_gather_sum(feat, pix, weight) - k3_ref).abs().max()
    k1_bound_ms, k1_by = k1_bound(data, vals, tiles_x)
    k3_bound_ms, k3_by = k3_bound(feat, pix, weight)
    check(k1_err.item() <= 1e-4, f"K1 on predict inputs: {k1_err.item()}")
    check(k3_err.item() <= 1e-5 * k3_ref.abs().max().item(),
          f"K3 on predict inputs: {k3_err.item()}")
    kernels = [
        dict(name="composite_tiles", route="cuda",
             source="mvsdet_torch/ops/csrc/composite_tiles.cu",
             replaces="mvsdet_tpu/ops/pallas/splat_kernel.py:48",
             launches=launches["composite_tiles"],
             max_abs_err=k1_err.item(),
             ms=cuda_ms(lambda: composite_tiles(data, vals, tiles_x)),
             plain_ms=cuda_ms(lambda: composite_tiles_reference(
                 data, vals, tiles_x), reps=3),
             bound_ms=k1_bound_ms, bound_by=k1_by, library_ms=None,
             shape=dict(tiles=data.shape[0], k=data.shape[2],
                        c=vals.shape[1])),
        dict(name="weighted_gather_sum", route="cuda",
             source="mvsdet_torch/ops/csrc/weighted_gather_sum.cu",
             replaces="mvsdet_tpu/ops/pallas/lift_kernel.py:41",
             launches=launches["weighted_gather_sum"],
             max_abs_err=k3_err.item(),
             ms=cuda_ms(lambda: weighted_gather_sum(feat, pix, weight)),
             plain_ms=cuda_ms(lambda: weighted_gather_sum_reference(
                 feat, pix, weight), reps=3),
             bound_ms=k3_bound_ms, bound_by=k3_by,
             library_ms=cuda_ms(embedding_bag_fn(feat, pix, weight)),
             shape=dict(n=feat.shape[0], hw=feat.shape[1], c=feat.shape[2],
                        v=pix.shape[1],
                        nonzero_weights=int((weight != 0).sum()))),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
