"""Training steps through the port's `fit`, the train launcher's loop:
one scene of the pool a step, the next one staged on fit's thread, the
losses read every `log_every` steps.

Set-up builds one train state and drives it through one `fit` call over
the pool's first `checked_steps` scenes, the output check's steps; the
window's `fit` then goes on with that same state.  The check compares
the first step's loss terms, the first clipped gradient (read from
AdamW's state by a hook on the optimizer's first step) and the
parameters after the checked steps with the reference's.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark import check, flops, runs, scenes
from benchmark.trace import KernelInputs, traced
from benchmark.weights import draw_weights, traffic_weights


def halved(batch: dict) -> dict:
    """A scene with the second half of its source views left out (a
    planted fault: half the batch dropped, the mean taken over the
    rest)."""
    n = batch["images"].shape[0]
    per_view = ("images", "denorm_images", "depth", "w2c")
    out = {k: (v[:n // 2] if k in per_view else v) for k, v in batch.items()}
    if batch["intrinsic"].ndim == 3:
        out["intrinsic"] = batch["intrinsic"][:n // 2]
    return out


def build_train(cfg, seed: int, weights: dict, device):
    """The port's train state with the seed's weights, as
    `create_train_state` builds it, the weights drawn on ``device``
    (``weights``: the rest of `draw_weights`' arguments)."""
    from mvsdet_torch.models.mvsdet import MVSDet
    from mvsdet_torch.training import loop
    from mvsdet_torch.training.optim import build_optimizer
    with torch.device(device):
        model = MVSDet(cfg.model)
    draw_weights(model, seed, **weights)
    model.train()
    optimizer, scheduler = build_optimizer(cfg.optim, model)
    return loop.TrainState(model, optimizer, scheduler,
                           max_norm=cfg.optim.grad_clip_norm)


def checked_steps(state, traffic, pool, fault: Optional[str] = None) -> dict:
    """The first `checked_steps` steps in one `fit` call, one scene of the
    pool each, as the window runs them: the losses `fit` logs (by step),
    each leaf's first clipped gradient norm, read from AdamW's state by a
    hook on the optimizer's first step, and the parameters after the
    last step."""
    from mvsdet_torch.training import loop

    # the planted faults of the check's tests, in the step fit calls
    original = loop.train_step
    step_of = original
    if fault == "unchanged":
        def step_of(state, batch):                      # noqa: F811
            state.step += 1
            with torch.no_grad():
                total, aux = state.model.loss(batch)
            return {"loss": total, **aux}
    elif fault == "half_batch":
        def step_of(state, batch):                      # noqa: F811
            return original(state, halved(batch))

    params = check.trainable(state.model)
    first = []

    def read_first(optimizer, args, kwargs):
        # exp_avg = (1 - beta1) g after the first step; queued, not read
        if not first:
            st = optimizer.state
            first.append(torch.stack([
                st[p]["exp_avg"].norm() if "exp_avg" in st.get(p, {})
                else p.new_zeros(()) for p in params.values()])
                / (1.0 - check.BETA1))

    n = traffic["checked_steps"]
    losses: Dict[int, Dict[str, float]] = {}
    loop.train_step = step_of
    hook = state.optimizer.register_step_post_hook(read_first)
    try:
        loop.fit(state, pool[:n], n, log_every=traffic["log_every"],
                 log_fn=losses.__setitem__)
    finally:
        hook.remove()
        loop.train_step = original
    norms = first[0].tolist() if first else [0.0] * len(params)
    p_end = {k: p.detach().clone() for k, p in params.items()}
    return dict(losses=losses, grads=dict(zip(params, norms)), p3=p_end)


def run(cell, cfg, values, seed: int, seconds: float, trace: bool, device,
        mark_window: Callable[[], None],
        fault: Optional[str] = None) -> runs.Run:
    """The checked steps in set-up, then the window, then with ``trace``
    a traced stretch of `trace_items` steps; the check after."""
    from mvsdet_torch.training import loop

    traffic = cell.traffic
    run = runs.Run()
    n_views, n_targets = runs.views(cfg, traffic)
    pool = scenes.make_pool(cfg, seed, traffic["pool"], n_views, n_targets,
                            cfg.model.head.with_yaw, device)
    state = build_train(cfg, seed, traffic_weights(traffic), device)
    prog = checked_steps(state, traffic, pool, fault)
    checked = traffic["checked_steps"]
    runs.sync(device)
    runs.log("checked steps done",
             losses={i: round(m["loss"], 6)
                     for i, m in prog["losses"].items()})

    logged = []
    start = state.step
    t_end = [0.0]

    def feed():
        i = checked
        while time.perf_counter() < t_end[0]:
            yield pool[i % len(pool)]
            i += 1

    runs.reset_peak(device)
    mark_window()
    t0 = time.perf_counter()
    t_end[0] = t0 + seconds
    try:
        loop.fit(state, feed(), 1 << 40, log_every=traffic["log_every"],
                 log_fn=lambda i, m: logged.append(m))
    except StopIteration:        # fit's feed ran dry: the window is over
        pass
    runs.sync(device)
    run.window_s = time.perf_counter() - t0
    run.items = state.step - start
    run.failed = sum(not np.isfinite(m["loss"]) for m in logged)
    run.window_peak_bytes = runs.peak(device)
    run.end_to_end["train_scenes_per_s"] = (run.items / run.window_s,
                                            "scenes/s")
    runs.log("window closed", steps=run.items,
             seconds=round(run.window_s, 3))

    if trace:
        kernels = KernelInputs()
        with kernels.installed():
            run.ctx["trace"] = traced(lambda: loop.fit(
                state, pool[:traffic["trace_items"]],
                traffic["trace_items"]))
        run.ctx["items_traced"] = traffic["trace_items"]
        run.ctx["kernel_bounds_ms"] = kernels.bounds_ms()
        run.ctx["flops_per_item"] = flops.scene_flops(
            check.reference_config(values), n_views, n_targets,
            True)["total"]
        del kernels
    run.peak_bytes = runs.peak(device)
    del state
    runs.free(device)

    t = time.perf_counter()
    ref = check.reference_train(values, seed, traffic_weights(traffic),
                                pool[:checked], device)
    run.numbers = check.judge_train(prog, ref)
    run.detail = check.train_detail(prog, ref)
    runs.log("reference done", seconds=round(time.perf_counter() - t, 3),
             losses=[round(m["loss"], 6) for m in ref["losses"]],
             detail=run.detail)
    return run


def control(cell, seed: int, device="cuda") -> dict:
    """The control's numbers at one seed: the reference's checked steps
    with TF32 on against the same steps with TF32 off."""
    values = cell.config["config"]
    traffic = cell.traffic
    cfg = check.reference_config(values)
    n_views, n_targets = runs.views(cfg, traffic)
    pool = scenes.make_pool(cfg, seed, traffic["checked_steps"], n_views,
                            n_targets, cfg.model.head.with_yaw, device)
    weights = traffic_weights(traffic)
    want = check.reference_train(values, seed, weights, pool, device)
    got = check.reference_train(values, seed, weights, pool, device,
                                use_tf32=True)
    got = dict(got, losses=dict(enumerate(got["losses"])))
    return dict(numbers=check.judge_train(got, want),
                detail=check.train_detail(got, want))
