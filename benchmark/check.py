"""The output check: the plain reference (`benchmark/reference/`) works
out again what the program's timed path produced, and each number
compared is printed beside its limit (`benchmark/limits/<cell>.json`).

Training: the reference takes the same seed-drawn weights and the same
three first scenes as the program's first three steps, which run in one
`fit` call as the window's do (`benchmark/modes/train.py`).  `loss_gap`
is the largest and `loss_min_gap` the smallest relative gap of the first
step's loss terms; `grad_gap`
the worst leaf's gap of the first clipped gradient's norm, which the
program's AdamW state holds after one step as exp_avg / (1 - beta1);
`update_gap` the median leaf's gap of the change over the three steps.
A leaf's gap is the gap between the two norms over the larger of the
reference's norm of that leaf and of the median leaf.
`update_gap` leaves out the leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding: AdamW moves them by
round-off alone).  The later steps' losses and the worst leaf's change
are not compared (`judge_train` says why); `train_detail` reports them.

Predict: for a sample of the window's predicts drawn from the seed, the
reference's predict of the same scene.  `render_gap` is the mean absolute
gap of the rendered target, `depth_gap` the largest absolute gap of the
depth expectation, `few_boxes` counts the sampled predicts that kept
fewer than the traffic's `check_min_kept` boxes (so that the box
numbers always have boxes to judge), and `box_misses` counts the kept
boxes that lie farther than `MATCH` (2 cm in every coordinate and 2% in
score) from every candidate of their class, and the faults of a kept list that is not
a greedy NMS of the reference's candidates (two kept boxes of a class
overlapping above the threshold, or a candidate above the score threshold
neither kept nor suppressed by a kept box of its class that scores at
least as high).  The rendered target is compared by its mean: the
compositor's depth order and the lift's top-k planes are discontinuous,
so a rounding-level difference swaps two near-equal splats or planes now
and then, which moves a few pixels by up to 2e-3 between two sound runs.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark import cells
from benchmark.weights import draw_weights

BETA1 = 0.9            # the AdamW first moment's decay (optim.py)
RELATIVE_FLOOR = 1e-12
# the slack of the NMS checks: a candidate within MATCH of a kept box is
# that box; a suppressing box may overlap down to iou_thr - IOU_SLACK and
# score SCORE_SLACK (relative) below the candidate
MATCH = 2e-2
IOU_SLACK = 2e-2
SCORE_SLACK = 1e-2


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for the block (matmuls and cuDNN convolutions)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_config(values):
    from benchmark.reference import config as ref_config
    return cells.build_config(ref_config, values)


def _staged(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def reference_model(cfg, seed: int, weights: dict, device, train: bool):
    """The reference's model with the seed's weights (``weights``: the
    rest of `draw_weights`' arguments)."""
    from benchmark.reference.models.mvsdet import MVSDet
    with torch.device(device):
        model = MVSDet(cfg.model)
    draw_weights(model, seed, **weights)
    return model.train(train)


def trainable(model) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def reference_train(values, seed: int, weights: dict,
                    batches: List[dict], device,
                    use_tf32: bool = False) -> dict:
    """The reference's steps over ``batches`` from the seed's weights:
    each step's loss terms, each leaf's first clipped gradient norm, the
    initial parameters and those after the last step."""
    from benchmark.reference.training import optim
    cfg = reference_config(values)
    model = reference_model(cfg, seed, weights, device, train=True)
    params = trainable(model)
    p0 = {n: p.detach().clone() for n, p in params.items()}
    optimizer, scheduler = optim.build_optimizer(cfg.optim, model)
    group_params = [p for g in optimizer.param_groups for p in g["params"]]
    losses, grads = [], None
    with tf32(use_tf32):
        for batch in batches:
            optimizer.zero_grad(set_to_none=True)
            total, aux = model.loss(_staged(batch, device))
            total.backward()
            for p in group_params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optim.clip_by_global_norm_(group_params, cfg.optim.grad_clip_norm)
            if grads is None:
                grads = {n: float(p.grad.norm()) for n, p in params.items()}
            optimizer.step()
            scheduler.step()
            losses.append({"loss": float(total.detach()),
                           **{k: float(v.detach()) for k, v in aux.items()}})
    p3 = {n: p.detach().clone() for n, p in params.items()}
    return dict(losses=losses, grads=grads, p0=p0, p3=p3)


def _leaf_gap(got: Dict[str, float], want: Dict[str, float], names) -> float:
    """The worst leaf's |got - want| over max(want, the median leaf's)."""
    names = list(names)
    if not names:
        return 0.0
    median = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], median,
                                            RELATIVE_FLOOR)
               for n in names)


def _change_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Each moving leaf's gap of its change's norm over the steps: the
    leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    grads = ref["grads"]
    g_med = statistics.median(grads.values())
    moving = [n for n, g in grads.items() if g >= 1e-3 * g_med]
    d_prog = {n: float((prog["p3"][n] - ref["p0"][n]).norm())
              for n in moving}
    d_ref = {n: float((ref["p3"][n] - ref["p0"][n]).norm()) for n in moving}
    d_med = statistics.median(d_ref.values())
    return {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], d_med,
                                                RELATIVE_FLOOR)
            for n in moving}


def judge_train(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: losses (step -> dict of floats, the steps `fit` logged,
    the first among them), grads (leaf ->
    first-gradient norm), p3 (leaf -> parameters after the last step);
    ``ref``: `reference_train`'s.

    `loss_gap` is the largest and `loss_min_gap` the smallest relative
    gap among the first step's loss terms.  A change of precision, or a
    fault that reaches the whole forward, moves every term; on about one
    seed in sixty the program and the reference part, the same on every
    run, in the head's terms alone, by up to 3.2e-4, while the render
    term agrees to the bit (`PERF.md`).  So the largest gap's limit lies
    above that, and the smallest gap is the number the control fails.
    `update_gap` reads the median leaf's change: each later step starts from parameters that
    AdamW moved by lr * g / (|g| + eps), which turns rounding-level
    gradient differences on elements near zero into whole steps of lr,
    so that the reference differs from itself run to run (cuDNN's
    nondeterministic weight gradients) by up to 0.13 in a later step's
    loss and by several percent in a small leaf's change (`PERF.md`).
    `train_detail` gives the later steps and the worst leaf."""
    gaps = _first_loss_gaps(prog, ref)
    grads = ref["grads"]
    update = statistics.median(_change_gaps(prog, ref).values())
    return {"loss_gap": max(gaps.values()),
            "loss_min_gap": min(gaps.values()),
            "grad_gap": _leaf_gap(prog["grads"], grads, grads),
            "update_gap": update}


def _first_loss_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Each of the first step's loss terms' relative gap, the terms the
    reference reads as nought left out (a scene with no positive box
    has no centerness or box loss); all infinite where the program logged
    no first step."""
    first = {k: w for k, w in ref["losses"][0].items()
             if k != "n_pos" and w != 0.0}
    if 0 not in prog["losses"]:
        return {k: float("inf") for k in first}
    return {k: abs(prog["losses"][0][k] - w) / abs(w)
            for k, w in first.items()}


def sample_calls(seed: int, order: List[int], k: int) -> List[int]:
    """The window's predicts the check compares: ``k`` distinct scenes of
    the pool drawn from the seed, each at a call drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    seen = sorted(set(order))
    scenes = [seen[i] for i in rng.permutation(len(seen))[:k]]
    return [int(rng.choice([i for i, s in enumerate(order) if s == scene]))
            for scene in scenes]


@torch.no_grad()
def reference_predict(values, seed: int, weights: dict,
                      batches: List[dict], device,
                      use_tf32: bool = False) -> List[dict]:
    """The reference's predict of each batch (host numpy, as the program's
    predict returns it) with its pre-NMS candidates above the score
    threshold: `cand_boxes` (centre format), `cand_scores`,
    `cand_labels`."""
    from benchmark.reference.models import head as ref_head
    from benchmark.reference.ops.nms import corner_to_center
    cfg = reference_config(values)
    model = reference_model(cfg, seed, weights, device, train=False)
    hc = cfg.model.head
    decode = ref_head.decode_bbox_rotated if hc.with_yaw \
        else ref_head.decode_bbox
    out = []
    with tf32(use_tf32):
        for batch in batches:
            # `MVSDet.predict` of the copy, its forward run once for the
            # prediction and the candidates both
            result = model(_staged(batch, device))
            predict_fn = ref_head.head_predict_rotated if hc.with_yaw \
                else ref_head.head_predict
            pred = predict_fn(result["head_outs"], result["points"],
                              result["valids"], hc)
            pred["rendered"] = result["rendered"]
            pred["depth_expect"] = result["depth_expect"]
            boxes, scores, labels = ref_head._candidates(
                result["head_outs"], result["points"], result["valids"], hc,
                decode)
            keep = scores > hc.score_thr
            boxes = boxes[keep] if hc.with_yaw \
                else corner_to_center(boxes[keep])
            pred.update(cand_boxes=boxes, cand_scores=scores[keep],
                        cand_labels=labels[keep])
            out.append({k: v.cpu().numpy() for k, v in pred.items()})
    return out


def _iou(a: np.ndarray, b: np.ndarray, with_yaw: bool,
         device) -> np.ndarray:
    """(M, N) IoU of centre-format boxes, by the reference's functions,
    on ``device``."""
    from benchmark.reference.ops import nms
    ta = torch.as_tensor(a, dtype=torch.float32, device=device)
    tb = torch.as_tensor(b, dtype=torch.float32, device=device)
    if with_yaw:
        return nms.rotated_iou_bev_exact(ta, tb).cpu().numpy()

    def corners(t):
        return torch.cat([t[:, :3] - t[:, 3:] / 2, t[:, :3] + t[:, 3:] / 2],
                         dim=1)
    return nms.aligned_iou_3d(corners(ta), corners(tb)).cpu().numpy()


def _box_gaps(prog: dict, ref: dict, head_cfg, device) -> tuple:
    """(each kept box's gap, NMS faults) of the program's kept boxes
    against the reference's candidates."""
    mask = prog["mask"].astype(bool)
    pb = prog["boxes"][mask].astype(np.float64)
    ps = prog["scores"][mask].astype(np.float64)
    pl = prog["labels"][mask]
    cb = ref["cand_boxes"].astype(np.float64)
    cs = ref["cand_scores"].astype(np.float64)
    cl = ref["cand_labels"]
    gaps = []
    dist = np.full((len(pb), len(cb)), np.inf)
    for i in range(len(pb)):
        same = cl == pl[i]
        if not same.any():
            gaps.append(float("inf"))
            continue
        d = np.maximum(np.abs(cb[same] - pb[i]).max(axis=1),
                       np.abs(cs[same] - ps[i]) / np.maximum(cs[same], 1e-6))
        dist[i, same] = d
        gaps.append(float(d.min()))
    faults = 0
    thr = head_cfg.iou_thr
    if len(pb):
        kept_iou = _iou(pb, pb, head_cfg.with_yaw, device)
        same = pl[:, None] == pl[None, :]
        np.fill_diagonal(same, False)
        faults += int(np.triu(same & (kept_iou > thr + IOU_SLACK)).sum())
        cross = _iou(pb, cb, head_cfg.with_yaw, device)               # (P, C)
        kept = (dist <= MATCH).any(axis=0)
        suppressed = ((pl[:, None] == cl[None, :])
                      & (cross >= thr - IOU_SLACK)
                      & (ps[:, None] >= cs[None, :] * (1 - SCORE_SLACK))
                      ).any(axis=0)
        full = len(pb) >= head_cfg.max_detections
        exempt = (cs <= ps.min() * (1 + SCORE_SLACK)) if full \
            else np.zeros(len(cs), bool)
        faults += int((~kept & ~suppressed & ~exempt).sum())
    elif len(cb):
        faults += len(cb)
    return gaps, faults


def predict_detail(prog: List[dict], ref: List[dict], head_cfg,
                   min_kept: int, device="cpu") -> dict:
    """Each output's gaps over the sampled predicts: the rendered target's
    largest and mean, the depth's largest, the kept boxes' largest, the
    boxes off every candidate and the NMS faults, the predicts that kept
    fewer than ``min_kept`` boxes, and each predict's kept boxes and
    reference candidates."""
    kept = [int(p["mask"].sum()) for p in prog]
    out = dict(render_max=0.0, render_mean=0.0, depth_max=0.0, box_max=0.0,
               box_misses=0, nms_faults=0, boxes=0,
               few_boxes=sum(k < min_kept for k in kept))
    detail = dict(kept=kept, candidates=[len(r["cand_scores"]) for r in ref])
    for p, r in zip(prog, ref):
        if p["rendered"].shape != r["rendered"].shape \
                or p["depth_expect"].shape != r["depth_expect"].shape:
            return dict({k: float("inf") for k in out}, **detail)
        dr = np.abs(p["rendered"].astype(np.float64) - r["rendered"])
        dd = np.abs(p["depth_expect"].astype(np.float64) - r["depth_expect"])
        gaps, faults = _box_gaps(p, r, head_cfg, device)
        out["render_max"] = max(out["render_max"], float(dr.max()))
        out["render_mean"] = max(out["render_mean"], float(dr.mean()))
        out["depth_max"] = max(out["depth_max"], float(dd.max()))
        out["box_max"] = max([out["box_max"]] + gaps)
        out["box_misses"] += sum(g > MATCH for g in gaps)
        out["nms_faults"] += faults
        out["boxes"] += len(gaps)
    return dict(out, **detail)


def judge_predict(prog: List[dict], ref: List[dict], head_cfg,
                  min_kept: int, device="cpu") -> Dict[str, float]:
    """The worst of each number over the sampled predicts:
    `render_gap`, the mean absolute gap of the rendered target;
    `depth_gap`, the largest absolute gap of the depth expectation (m);
    `few_boxes`, the predicts that kept fewer than ``min_kept`` boxes;
    `box_misses`, the kept boxes farther than
    `MATCH` from every candidate of their class, and the NMS faults."""
    d = predict_detail(prog, ref, head_cfg, min_kept, device)
    return {"render_gap": d["render_mean"], "depth_gap": d["depth_max"],
            "few_boxes": float(d["few_boxes"]),
            "box_misses": float(d["box_misses"] + d["nms_faults"])}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def train_detail(prog: dict, ref: dict) -> dict:
    """Where the training numbers come from: the first step's gap of each
    loss term, each step's largest relative loss-term gap and its term,
    the worst leaves of the first gradient
    and of the change, and the median leaf's gaps."""
    steps = [(0, "first", {k: float(f"{v:.3g}") for k, v in
                           _first_loss_gaps(prog, ref).items()})]
    for i, got in sorted(prog["losses"].items()):
        want = ref["losses"][i] if i < len(ref["losses"]) else {}
        gaps = {k: abs(got[k] - w) / max(abs(w), RELATIVE_FLOOR)
                for k, w in want.items() if k != "n_pos"}
        if gaps:
            k = max(gaps, key=gaps.get)
            steps.append((i, k, gaps[k]))
    grads = ref["grads"]
    g_med = statistics.median(grads.values())
    g_gap = {n: abs(prog["grads"][n] - g) / max(g, g_med, RELATIVE_FLOOR)
             for n, g in grads.items()}
    u_gap = _change_gaps(prog, ref)
    worst_g = max(g_gap, key=g_gap.get)
    worst_u = max(u_gap, key=u_gap.get)
    return dict(steps=steps,
                grad_worst=(worst_g, g_gap[worst_g], grads[worst_g]),
                grad_median=statistics.median(g_gap.values()),
                update_worst=(worst_u, u_gap[worst_u]),
                update_median=statistics.median(u_gap.values()),
                update_top=sorted(((round(v, 5), n) for n, v in
                                   u_gap.items()), reverse=True)[:6],
                leaves=len(grads), moving=len(u_gap))
