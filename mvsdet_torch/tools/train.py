"""Training launcher (port of tools/train.py:26-301).

    python -m mvsdet_torch.tools.train --infos data/scannet/scannet_infos_train_new.pkl \\
        --data-root data/scannet --work-dir work_dirs/mvsdet_torch
    python -m mvsdet_torch.tools.train --synthetic 8 --dtype bfloat16
    python -m mvsdet_torch.tools.train --tiny --synthetic 2 --steps 3 --device cpu
    python -m mvsdet_torch.tools.train --model nerfdet --synthetic 8 \
        --val-synthetic 2
    torchrun --standalone --nproc_per_node 4 -m mvsdet_torch.tools.train \
        --synthetic 8 --data-parallel 2 --view-parallel 2

Trains on one card (unless `--device cpu`): `create_train_state`, then
one `training.loop.fit` per epoch, which stages the scenes one ahead on a
thread (`data/prefetch.py`).  Under torchrun, `--data-parallel D
--view-parallel V` trains on a D x V mesh of its D * V processes
(`parallel/`, the JAX launcher's `shard_map` step): at step k, data row d
takes scene k * D + d of the seeded stream and its V ranks split that
scene's views; each rank takes the card `LOCAL_RANK` names (modulo the
cards there are), on NCCL where each has one of its own, on gloo where
they share.  Rank 0 alone logs, evaluates and saves; the others wait for
it at a barrier.  An epoch is still `steps_per_epoch` steps, as the JAX
launcher counts it (tools/train.py:129).  Each epoch ends with a save of
`latest` and, with `--val-infos` or `--val-synthetic`, an evaluation whose
best `mAP_0.25` is kept as `best` (the reference's val_cfg + CheckpointHook
save_best, mvsdet_res50_2x_low_res.py:164-172); a resumed run reads the
best so far back from the work dir's log, a fresh run starts its own.
Every record goes to `<work-dir>/train_log.jsonl`: step records (`step`,
`time` in seconds since the first step began, read after the step's
losses reach the host, and the loss terms) for every `--log-every`-th step of an epoch
and its last, checkpoint saves (`saved`, `save_s`) and evaluations
(`eval`, the metric dict), after a first record of the layout
(`backend`, `world`, `data_parallel`, `view_parallel`).  `--resume`
continues at the checkpoint's step and at that step's place in the
seeded scene stream.

`--model nerfdet` trains the legacy NeRF-Det instead
(`create_nerfdet_state`, its step drawing the rays from `--seed` and the
step number), on one device, in `--dtype`, and evaluates it as MVSDet.
It refuses `--data-parallel` or `--view-parallel` above 1, as the JAX
launcher does (tools/train.py:137-141).
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
import torch.distributed as dist

from mvsdet_torch.config import Config, scannet_config, tiny_test_config
from mvsdet_torch.data.infos import load_infos
from mvsdet_torch.data.pipeline import ScenePipeline, scene_iterator
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import evaluate_scenes, make_predict_fn
from mvsdet_torch.models.mvsdet import DEPTH_SUPERVISION_SHARDED
from mvsdet_torch.parallel import multihost
from mvsdet_torch.training.loop import (TrainState, create_nerfdet_state,
                                        create_train_state, fit,
                                        load_checkpoint,
                                        load_pretrained_backbone,
                                        save_checkpoint)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train MVSDet (PyTorch port)")
    p.add_argument("--model", choices=["mvsdet", "nerfdet"], default="mvsdet",
                   help="model family: the flagship MVSDet or the legacy "
                        "NeRF-Det (the reference trains both, "
                        "nerfdet/nerfdet.py:20 vs mvsdet.py:122)")
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
    p.add_argument("--data-parallel", type=int, default=1,
                   help="scenes per step, one per data row of ranks "
                        "(under torchrun)")
    p.add_argument("--view-parallel", type=int, default=1,
                   help="ranks that split each scene's views (under "
                        "torchrun)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card; "
                        "under torchrun the card LOCAL_RANK names) or "
                        "'cpu'")
    args = p.parse_args(argv)
    if args.model == "nerfdet":
        if args.data_parallel * args.view_parallel > 1:
            p.error("--model nerfdet trains on one device only, as the JAX "
                    "launcher does (like the reference's per-GPU NerfDet); "
                    "leave --data-parallel and --view-parallel at 1")
    return args


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


def best_logged_map(log_path: str) -> float:
    """The highest mAP_0.25 of the evaluations in a `train_log.jsonl`, the
    one `best` was saved at; -1 where there is no log or no evaluation."""
    if not os.path.exists(log_path):
        return -1.0
    with open(log_path) as f:
        evals = [rec["eval"] for rec in map(json.loads, f) if "eval" in rec]
    return max((e.get("mAP_0.25", 0.0) for e in evals), default=-1.0)


def train(cfg: Config, args: argparse.Namespace) -> TrainState:
    """Run the training ``args`` ask for with ``cfg`` (already configured)
    and return the final train state.  In a process group (`main` under
    torchrun) the ranks form a `--data-parallel` x `--view-parallel`
    mesh."""
    device = multihost.local_device(args.device)
    n_dp, n_vp = args.data_parallel, args.view_parallel
    if n_vp > 1 and cfg.model.depth_supervision:
        raise ValueError(DEPTH_SUPERVISION_SHARDED)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_dp * n_vp != world:
        raise ValueError(f"--data-parallel {n_dp} x --view-parallel {n_vp} "
                         f"needs {n_dp * n_vp} processes (torchrun "
                         f"--nproc_per_node), not {world}")
    mesh = multihost.make_global_mesh(n_dp, n_vp) if dist.is_initialized() \
        else None
    row = mesh.data_index if mesh is not None else 0
    lead = mesh is None or mesh.rank == 0
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

    if args.model == "nerfdet":
        state = create_nerfdet_state(
            cfg, device=device,
            generator=torch.Generator().manual_seed(args.seed),
            steps_per_epoch=steps_per_epoch, seed=args.seed,
            dtype=DTYPES[args.dtype])
    else:
        state = create_train_state(
            cfg, device=device,
            generator=torch.Generator().manual_seed(args.seed),
            steps_per_epoch=steps_per_epoch, sweep_chunk=args.sweep_chunk,
            dtype=DTYPES[args.dtype])
    if args.pretrained:
        load_pretrained_backbone(state, args.pretrained)
    if args.resume:
        load_checkpoint(args.resume, state)

    # step k of data row d: scene k * D + d of the one seeded stream, from
    # the checkpoint's step on; the real-data stream draws the positions
    # before it and the other rows' without decoding them
    if args.synthetic:
        batches = (scenes[(i * n_dp + row) % len(scenes)]
                   for i in itertools.count(state.step))
    else:
        batches = scene_iterator(infos, ScenePipeline(cfg, training=True),
                                 seed=args.seed, repeat=0,
                                 start=state.step * n_dp + row, stride=n_dp)

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

    do_eval = lead and bool(args.val_synthetic or args.val_infos)
    predict = make_predict_fn(state.model, device) if do_eval else None
    log_path = os.path.join(args.work_dir, "train_log.jsonl")
    # a resumed run replaces `best` only with a higher mAP_0.25 than the
    # work dir's log records; a fresh run keeps its own best, as JAX's does
    best_map = best_logged_map(log_path) if args.resume else -1.0

    def log(rec):
        print(json.dumps(rec), flush=True)
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def save(name, step):
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(args.work_dir, name), state)
        log({"step": step, "saved": name, "save_s": time.perf_counter() - t0})

    if lead:
        os.makedirs(args.work_dir, exist_ok=True)
        log({"backend": dist.get_backend() if mesh is not None else None,
             "world": world, "data_parallel": n_dp, "view_parallel": n_vp,
             "device": str(device)})

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
            log_every=args.log_every, log_fn=log_step if lead else None,
            mesh=mesh)
        last = state.step - 1
        if lead:
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
        if mesh is not None:
            dist.barrier()          # the others wait for rank 0's saves
    return state


def main(argv=None) -> TrainState:
    """Parse ``argv`` and train; under torchrun, join its process group
    first and leave it at the end."""
    args = parse_args(argv)
    # float32 is full float32, as the JAX package computes it: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_test_config() if args.tiny else scannet_config()
    joined = multihost.initialize(multihost.local_device(args.device))
    try:
        return train(configure(cfg, args), args)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
