"""Training launcher (port of tools/train.py:26-301).

    python -m mvsdet_torch.tools.train --infos data/scannet/scannet_infos_train_new.pkl \\
        --data-root data/scannet --work-dir work_dirs/mvsdet_torch
    python -m mvsdet_torch.tools.train --synthetic 8 --dtype bfloat16
    python -m mvsdet_torch.tools.train --tiny --synthetic 2 --steps 3 --device cpu

Trains on one card (unless `--device cpu`): `create_train_state`, then
one `training.loop.fit` per epoch, which stages the scenes one ahead on a
thread (`data/prefetch.py`).  Each epoch ends with a save of `latest`
and, with `--val-infos` or `--val-synthetic`, an evaluation whose best
`mAP_0.25` is kept as `best` (the reference's val_cfg + CheckpointHook
save_best, mvsdet_res50_2x_low_res.py:164-172).  Every record goes to
`<work-dir>/train_log.jsonl`: step records (`step`, `time` in seconds
since the first step began, read after the step's losses reach the
host, and the loss terms) for every `--log-every`-th step of an epoch
and its last, checkpoint saves (`saved`, `save_s`) and evaluations
(`eval`, the metric dict).  `--resume` continues at the checkpoint's
step.

Not accepted yet: `--model nerfdet` (legacy NeRF-Det) and
`--data-parallel` / `--view-parallel` with multi-host, which wait for the
port's NeRF-Det and parallelism.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time

import numpy as np
import torch

from mvsdet_torch.config import Config, scannet_config, tiny_test_config
from mvsdet_torch.data.infos import load_infos
from mvsdet_torch.data.pipeline import ScenePipeline, scene_iterator
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import evaluate_scenes, make_predict_fn
from mvsdet_torch.training.loop import (TrainState, create_train_state, fit,
                                        load_checkpoint,
                                        load_pretrained_backbone,
                                        save_checkpoint)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train MVSDet (PyTorch port)")
    p.add_argument("--infos", help="path to *_infos_train_new.pkl")
    p.add_argument("--data-root", default="", help="dataset root")
    p.add_argument("--work-dir", default="work_dirs/mvsdet_torch")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic scenes instead of a dataset")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_test_config shapes (CPU smoke runs)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="total steps (default: epochs x steps per epoch)")
    p.add_argument("--sweep-chunk", type=int, default=8)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                   help="compute dtype; parameters and optimizer stay "
                        "float32 (the reference's AMP option, ref "
                        "tools/train.py:104-114)")
    p.add_argument("--n-views", type=int, default=None,
                   help="views per training scene, targets included")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--resume", default=None, help="checkpoint to resume")
    p.add_argument("--pretrained", default=None,
                   help="torchvision resnet50 checkpoint (.pth/.npz) for the "
                        "backbone (ref torchvision://resnet50, "
                        "mvsdet_res50_2x_low_res_depth.py:25)")
    p.add_argument("--val-infos", default=None,
                   help="path to *_infos_val_new.pkl: evaluate each epoch "
                        "and keep the best-by-mAP_0.25 checkpoint")
    p.add_argument("--val-synthetic", type=int, default=0,
                   help="evaluate on N synthetic scenes each epoch")
    p.add_argument("--val-max-scenes", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10,
                   help="write a step record every N steps of an epoch "
                        "(and its last)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    return p.parse_args(argv)


def configure(cfg: Config, args: argparse.Namespace) -> Config:
    """``cfg`` with the learning rate and the training views of ``args``."""
    if args.lr is not None:
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, lr=args.lr))
    if args.n_views is not None:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          n_views_train=args.n_views))
    return cfg


def train(cfg: Config, args: argparse.Namespace) -> TrainState:
    """Run the training ``args`` ask for with ``cfg`` (already configured)
    and return the final train state."""
    device = torch.device(args.device)
    n_targets = cfg.data.nerf_target_views_train
    if args.synthetic:
        scenes = [make_synthetic_scene(cfg, seed=s,
                                       n_views=cfg.data.n_src_train,
                                       n_targets=n_targets)
                  for s in range(args.synthetic)]
        steps_per_epoch = len(scenes)
    else:
        infos = load_infos(args.infos, args.data_root, cfg.data.classes)
        steps_per_epoch = len(infos) * cfg.data.repeat
    epochs = args.epochs or cfg.optim.max_epochs
    total_steps = args.steps or epochs * steps_per_epoch

    state = create_train_state(
        cfg, device=device,
        generator=torch.Generator().manual_seed(args.seed),
        steps_per_epoch=steps_per_epoch, sweep_chunk=args.sweep_chunk,
        dtype=DTYPES[args.dtype])
    if args.pretrained:
        load_pretrained_backbone(state, args.pretrained)
    if args.resume:
        load_checkpoint(args.resume, state)

    if args.synthetic:
        batches = (scenes[i % len(scenes)]
                   for i in itertools.count(state.step))
    else:
        batches = scene_iterator(infos, ScenePipeline(cfg, training=True),
                                 seed=args.seed, repeat=0)

    val_scenes = None
    if args.val_synthetic:
        val_scenes = [
            make_synthetic_scene(cfg, seed=5000 + s,
                                 n_views=cfg.data.n_src_test,
                                 n_targets=cfg.data.nerf_target_views_test)
            for s in range(args.val_synthetic)]
    elif args.val_infos:
        val_infos = load_infos(args.val_infos, args.data_root,
                               cfg.data.classes)[:args.val_max_scenes]
        val_pipeline = ScenePipeline(cfg, training=False)

    def val_iter():
        if val_scenes is not None:
            return iter(val_scenes)
        # each scene's view sampler keyed by its index, whatever the count
        return (val_pipeline(s, np.random.RandomState(args.seed + i))
                for i, s in enumerate(val_infos))

    do_eval = bool(args.val_synthetic or args.val_infos)
    predict = make_predict_fn(state.model, device) if do_eval else None
    best_map = -1.0

    os.makedirs(args.work_dir, exist_ok=True)
    log_path = os.path.join(args.work_dir, "train_log.jsonl")

    def log(rec):
        print(json.dumps(rec), flush=True)
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def save(name, step):
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(args.work_dir, name), state)
        log({"step": step, "saved": name, "save_s": time.perf_counter() - t0})

    t_start = time.perf_counter()
    while state.step < total_steps:
        first = state.step
        n = min(steps_per_epoch - first % steps_per_epoch,
                total_steps - first)

        def log_step(i, values, first=first):
            log({"step": first + i, "time": time.perf_counter() - t_start,
                 **values})

        # islice: fit's prefetch thread draws nothing past the epoch's end
        fit(state, itertools.islice(batches, n), n,
            log_every=args.log_every, log_fn=log_step)
        last = state.step - 1
        save("latest", last)
        if do_eval:
            state.model.eval()
            results = evaluate_scenes(predict, val_iter(),
                                      cfg.model.head.n_classes, device=device)
            state.model.train()
            log({"step": last, "eval": results})
            if results.get("mAP_0.25", 0.0) > best_map:
                best_map = results["mAP_0.25"]
                save("best", last)
    return state


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    # float32 is full float32, as the JAX package computes it: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_test_config() if args.tiny else scannet_config()
    return train(configure(cfg, args), args)


if __name__ == "__main__":
    main()
