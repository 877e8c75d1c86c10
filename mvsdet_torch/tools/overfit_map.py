"""Detection-learning check: overfit a few synthetic scenes until mAP@0.25
rises (port of scripts/overfit_map.py).

    python -m mvsdet_torch.tools.overfit_map --steps 150 --eval-every 50
    python -m mvsdet_torch.tools.overfit_map --arkit --seed 1 --steps 200 \\
        --dtype bfloat16
    python -m mvsdet_torch.tools.overfit_map --model nerfdet --steps 300 \\
        --eval-every 100
    python -m mvsdet_torch.tools.overfit_map --device cpu --steps 2 \\
        --eval-every 1 --scenes 1

Trains on K fixed synthetic scenes of 4 views and 2 targets and
evaluates mAP on those same scenes: the whole chain (target assignment,
the focal, IoU and centerness losses, the AdamW groups, box decode, NMS
and the greedy-AP evaluation) learns when mAP_0.25 climbs from about 0
and holds.  `tests/test_torch_port_learning.py` gates it with the JAX
package's steps, seeds and gates.  Runs on the card unless `--device cpu`
is given; `--dtype bfloat16` is the models' compute dtype (parameters,
gradients and AdamW state stay float32).  Prints one JSON record per
evaluation (`step`, `t`, `mAP_0.25`, `mAP_0.50`, `mAR_0.25`, `psnr`), one
loss record every 25 steps, and a final `summary` line; `--out DIR` also
appends them to DIR/overfit_log.jsonl.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from mvsdet_torch.config import Config, tiny_test_config
from mvsdet_torch.data.prefetch import stage_batch
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import evaluate_scenes, make_predict_fn
from mvsdet_torch.training.loop import (create_nerfdet_state,
                                        create_train_state, step_fn)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def overfit_config(lr: float = 1e-3, arkit: bool = False,
                   total_steps: int = 0, costreg_norm: str = "group",
                   rotated_loss: Optional[str] = None) -> Config:
    """`tiny_test_config()` with a voxel grid that covers the synthetic
    scene (scripts/overfit_map.py:30-66): 16x16x8 voxels of 0.2 m (3.2 x
    3.2 x 1.6 m about the origin) hold every box, where the tiny 8x8x4 of
    0.16 m misses the spheres at +-1.2 m.  With ``arkit`` the head is the
    7-dim yaw head; ``rotated_loss`` picks its box loss.

    ``total_steps`` puts the reference's MultiStepLR shape on the run: x0.1
    at 8/12 and 11/12 of the steps (the reference decays at epochs 8 and
    11 of 12); 0 keeps the learning rate constant.
    """
    base = tiny_test_config()
    head = base.model.head
    if arkit:
        head = dataclasses.replace(head, n_reg_outs=7, with_yaw=True)
    if rotated_loss:
        head = dataclasses.replace(head, rotated_bbox_loss=rotated_loss)
    model = dataclasses.replace(
        base.model, n_voxels=(16, 16, 8), voxel_size=(0.2, 0.2, 0.2),
        head=head, cost_reg_norm=costreg_norm)
    if total_steps > 0:
        milestones = (max(1, total_steps * 8 // 12),
                      max(2, total_steps * 11 // 12))
    else:
        milestones = (10_000_000,)
    optim = dataclasses.replace(base.optim, lr=lr, milestones=milestones)
    return dataclasses.replace(base, model=model, optim=optim)


def run(steps: int, eval_every: int, n_scenes: int, lr: float, seed: int,
        log_fn: Callable[[str], None] = print, arkit: bool = False,
        model_family: str = "mvsdet", costreg_norm: str = "group",
        rotated_loss: Optional[str] = None, device="cuda",
        dtype: torch.dtype = torch.float32) -> List[Dict]:
    """Train ``steps`` steps over ``n_scenes`` synthetic scenes (seeds
    ``seed`` onwards), scene i % n_scenes at step i, and evaluate mAP on
    the same scenes at step 0, every ``eval_every`` steps and at the end.
    The weights are the JAX package's `run` draws from `PRNGKey(seed)`
    (`models/flax_init.py`: the same on every machine and torch version),
    and NeRF-Det's rays are drawn from ``seed``.
    Returns the evaluation records; every record also goes to ``log_fn``
    as a JSON line, as does each 25th step's loss."""
    cfg = overfit_config(lr=lr, arkit=arkit, total_steps=steps,
                         costreg_norm=costreg_norm, rotated_loss=rotated_loss)
    scenes = [make_synthetic_scene(cfg, seed=seed + s, n_views=4,
                                   n_targets=2, arkit=arkit)
              for s in range(n_scenes)]
    # milestones are step-valued (overfit_config scales them to the run);
    # the weights are the ones JAX's run draws from PRNGKey(seed)
    if model_family == "nerfdet":
        state = create_nerfdet_state(cfg, device=device, steps_per_epoch=1,
                                     seed=seed, dtype=dtype, flax_seed=seed)
    else:
        state = create_train_state(cfg, device=device, steps_per_epoch=1,
                                   sweep_chunk=2, dtype=dtype,
                                   flax_seed=seed)
    device = next(state.model.parameters()).device
    batches = [stage_batch(s, device) for s in scenes]
    step = step_fn(state)
    predict = make_predict_fn(state.model, device)

    def eval_map() -> Dict[str, float]:
        state.model.eval()
        res = evaluate_scenes(predict, scenes,
                              num_classes=cfg.model.head.n_classes)
        state.model.train()
        return res

    history = []
    t0 = time.time()
    for i in range(steps + 1):
        if i % eval_every == 0 or i == steps:
            res = eval_map()
            rec = {"step": i, "t": round(time.time() - t0, 1),
                   "mAP_0.25": round(res["mAP_0.25"], 4),
                   "mAP_0.50": round(res["mAP_0.50"], 4),
                   "mAR_0.25": round(res["mAR_0.25"], 4),
                   "psnr": round(res.get("psnr", 0.0), 2)}
            history.append(rec)
            log_fn(json.dumps(rec))
        if i == steps:
            break
        metrics = step(batches[i % len(batches)])
        if i % 25 == 0:
            log_fn(json.dumps({"step": i,
                               "loss": round(float(metrics["loss"]), 4)}))
    return history


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arkit", action="store_true",
                   help="7-dim yaw head, per-view intrinsics and the "
                        "rotated-IoU evaluation")
    p.add_argument("--model", choices=["mvsdet", "nerfdet"],
                   default="mvsdet",
                   help="model family (nerfdet: the legacy NeRF-MLP "
                        "supervision, ref nerfdet/nerfdet.py:20)")
    p.add_argument("--rotated-loss", choices=["rotated_iou", "decoupled"],
                   default=None, help="the ARKit head's box loss")
    p.add_argument("--costreg-norm", choices=["group", "batch"],
                   default="group", help="CostRegNet's norm")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                   help="compute dtype; parameters and optimizer stay "
                        "float32")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    p.add_argument("--out", default=None,
                   help="also append the records to <out>/overfit_log.jsonl")
    return p.parse_args(argv)


def main(argv=None) -> List[Dict]:
    """Parse ``argv``, run, print the summary line; returns the history."""
    args = parse_args(argv)
    # float32 is full float32, as the JAX package computes it: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sink = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        sink = open(os.path.join(args.out, "overfit_log.jsonl"), "a")

    def log(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        history = run(args.steps, args.eval_every, args.scenes, args.lr,
                      args.seed, log_fn=log, arkit=args.arkit,
                      model_family=args.model,
                      costreg_norm=args.costreg_norm,
                      rotated_loss=args.rotated_loss, device=args.device,
                      dtype=DTYPES[args.dtype])
        log(json.dumps({"summary": {
            "first_mAP_0.25": history[0]["mAP_0.25"],
            "last_mAP_0.25": history[-1]["mAP_0.25"]}}))
    finally:
        if sink:
            sink.close()
    return history


if __name__ == "__main__":
    main()
