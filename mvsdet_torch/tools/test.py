"""Evaluation launcher (port of tools/test.py:26-168).

    python -m mvsdet_torch.tools.test --infos data/scannet/scannet_infos_val_new.pkl \\
        --data-root data/scannet --checkpoint work_dirs/mvsdet_torch/best
    python -m mvsdet_torch.tools.test --synthetic 4 --arkit --dtype bfloat16
    python -m mvsdet_torch.tools.test --synthetic 2 --device cpu
    torchrun --standalone --nproc_per_node 2 -m mvsdet_torch.tools.test \
        --synthetic 4 --data-parallel 2

Predicts every scene on one card (unless `--device cpu`) and prints the
metric dict of `evaluation/harness.py`'s `evaluate_scenes` as one JSON
line: mAP_0.25, mAP_0.50 and the per-class APs (rotated IoU with
`--arkit`), psnr and ssim of the rendered target views, mvs_rmse with
`--load-depth`, predict_s_first and predict_s_per_scene.  The scenes are
read and staged one ahead of the predict.  Without `--checkpoint` the
weights are random, drawn from the configuration's seed.  Under
torchrun, `--data-parallel D` predicts D scenes at a time, one on each of
its D processes (`make_sharded_predict_fn`, the reference's
`tools/dist_test.sh`), with the metrics of one process; rank 0 prints
them.

Not accepted yet: `--diagnostics` and `--vis-dir`, which wait for the
port's diagnostics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist

from mvsdet_torch.config import (Config, arkit_config, scannet_config,
                                 tiny_test_config)
from mvsdet_torch.data.infos import load_infos
from mvsdet_torch.data.pipeline import ScenePipeline
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.evaluation.harness import (evaluate_scenes,
                                             make_predict_fn,
                                             make_sharded_predict_fn)
from mvsdet_torch.parallel import multihost
from mvsdet_torch.training.loop import create_predict_state

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate MVSDet (PyTorch port)")
    p.add_argument("--infos", help="path to *_infos_val_new.pkl")
    p.add_argument("--data-root", default="")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint the train launcher saved")
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate N synthetic scenes instead of a dataset")
    p.add_argument("--arkit", action="store_true",
                   help="ARKitScenes preset (per-view K, yaw head)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_test_config shapes (CPU smoke runs)")
    p.add_argument("--n-views", type=int, default=None,
                   help="views per scene, the target included")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                   help="compute dtype (parameters stay float32)")
    p.add_argument("--sweep-chunk", type=int, default=8)
    p.add_argument("--max-scenes", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="scene i's view sampler is seeded with seed + i")
    p.add_argument("--load-depth", action="store_true",
                   help="load GT depth for the mvs_rmse metric")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="scenes predicted at a time, one per process "
                        "(under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card; "
                        "under torchrun the card LOCAL_RANK names) or "
                        "'cpu'")
    return p.parse_args(argv)


def preset(args: argparse.Namespace) -> Config:
    """The configuration ``args`` name: ARKit, tiny or ScanNet."""
    if args.arkit and args.tiny:
        raise ValueError("--arkit and --tiny are two presets; pick one")
    return (arkit_config() if args.arkit else
            tiny_test_config() if args.tiny else scannet_config())


def scenes(cfg: Config, args: argparse.Namespace) -> Iterator[Dict]:
    """The host batches to evaluate, built as they are pulled."""
    n_targets = cfg.data.nerf_target_views_test
    if args.synthetic:
        for s in range(args.synthetic):
            yield make_synthetic_scene(cfg, seed=1000 + s,
                                       n_views=cfg.data.n_src_test,
                                       n_targets=n_targets, arkit=args.arkit)
        return
    infos = load_infos(args.infos, args.data_root,
                       cfg.data.classes)[:args.max_scenes]
    pipeline = ScenePipeline(cfg, training=False, load_depth=args.load_depth)
    # each scene's view sampler keyed by its index: the views sampled for
    # scene i depend neither on --max-scenes nor on the order
    for i, info in enumerate(infos):
        yield pipeline(info, np.random.RandomState(args.seed + i))


def evaluate(cfg: Config, args: argparse.Namespace) -> Dict[str, float]:
    """The metric dict of the evaluation ``args`` ask for, with ``cfg``;
    in a process group (`main` under torchrun) its `--data-parallel`
    processes predict a scene each."""
    if args.n_views is not None:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          n_views_test=args.n_views))
    device = multihost.local_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.data_parallel != world:
        raise ValueError(f"--data-parallel {args.data_parallel} needs as "
                         f"many processes (torchrun --nproc_per_node), not "
                         f"{world}")
    model = create_predict_state(cfg, args.checkpoint, device=device,
                                 dtype=DTYPES[args.dtype],
                                 sweep_chunk=args.sweep_chunk)
    if dist.is_initialized():
        mesh = multihost.make_global_mesh(args.data_parallel, 1)
        predict = make_sharded_predict_fn(model, mesh, device)
    else:
        predict = make_predict_fn(model, device)
    return evaluate_scenes(predict, scenes(cfg, args),
                           cfg.model.head.n_classes, device=device,
                           group_size=args.data_parallel)


def main(argv=None) -> Dict[str, float]:
    """Parse ``argv``, evaluate and print the metric dict (rank 0 under
    torchrun, after joining its process group)."""
    args = parse_args(argv)
    # float32 is full float32, as the JAX package computes it: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = multihost.initialize(multihost.local_device(args.device))
    try:
        results = evaluate(preset(args), args)
    finally:
        if joined:
            dist.destroy_process_group()
    if not joined or int(os.environ["RANK"]) == 0:
        print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
