"""Evaluation launcher (port of tools/test.py:26-168).

    python -m mvsdet_torch.tools.test --infos data/scannet/scannet_infos_val_new.pkl \\
        --data-root data/scannet --checkpoint work_dirs/mvsdet_torch/best
    python -m mvsdet_torch.tools.test --synthetic 4 --arkit --dtype bfloat16
    python -m mvsdet_torch.tools.test --synthetic 2 --device cpu
    python -m mvsdet_torch.tools.test --synthetic 3 --diagnostics \
        --vis-dir out/vis
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

`--diagnostics` adds the predict's diagnostics: depth_rmse of the
rendered target depth against GT, and the lift's weight_gap and
src_rmse.  `--vis-dir DIR` implies them and writes, per scene, into
DIR/sceneNNNN (rank 0 alone under torchrun): the predicted (green) and GT
(red) boxes projected on the first three source views, the rendered and
GT target views, the colourised rendered depth and source-view depth
expectations, and the Gaussians as a 3DGS .ply (the reference's
`vis_dir`, mvsdet.py:976-982).
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
from mvsdet_torch.utils.box_vis import overlay_detections
from mvsdet_torch.utils.imageio import colorize_depth, write_png
from mvsdet_torch.utils.ply_export import export_ply

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
    p.add_argument("--diagnostics", action="store_true",
                   help="rendered depth + weight_gap/src_rmse metrics")
    p.add_argument("--vis-dir", default=None,
                   help="dump rendered/GT/depth images + gaussian .ply "
                        "(implies --diagnostics)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="scenes predicted at a time, one per process "
                        "(under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card; "
                        "under torchrun the card LOCAL_RANK names) or "
                        "'cpu'")
    args = p.parse_args(argv)
    # the images need the diagnostics' outputs (tools/test.py:153)
    args.diagnostics = args.diagnostics or bool(args.vis_dir)
    return args


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


def make_vis_hook(vis_dir: str, cfg: Config):
    """fn(scene_index, scene, prediction) writing the scene's images and
    Gaussians into ``vis_dir``/sceneNNNN (tools/test.py:58-101)."""
    os.makedirs(vis_dir, exist_ok=True)

    def hook(si, scene, out):
        d = os.path.join(vis_dir, f"scene{si:04d}")
        os.makedirs(d, exist_ok=True)
        if "boxes" in out:
            # predictions green, GT red, on the first few source views
            mask = out["mask"]
            gmask = np.asarray(scene["gt_mask"])
            k = np.asarray(scene["intrinsic"])
            for i in range(min(3, scene["images"].shape[0])):
                k_i = k if k.ndim == 2 else k[i]
                img = overlay_detections(
                    np.asarray(scene["denorm_images"][i]),
                    np.asarray(scene["w2c"][i]), k_i,
                    out["boxes"][mask], out["scores"][mask],
                    np.asarray(scene["gt_boxes"])[gmask])
                write_png(os.path.join(d, f"boxes_{i}.png"), img)
        if "rendered" in out:
            for t in range(out["rendered"].shape[0]):
                write_png(os.path.join(d, f"render_{t}.png"),
                          out["rendered"][t])
                write_png(os.path.join(d, f"gt_{t}.png"),
                          np.asarray(scene["gt_images"][t]))
        if "rendered_depth" in out:
            for t in range(out["rendered_depth"].shape[0]):
                write_png(os.path.join(d, f"render_depth_{t}.png"),
                          colorize_depth(out["rendered_depth"][t]))
        if "depth_expect" in out:
            # a few source-view depth maps (the reference's save_src_depth
            # picks 3)
            for i in range(min(3, out["depth_expect"].shape[0])):
                write_png(os.path.join(d, f"src_depth_{i}.png"),
                          colorize_depth(out["depth_expect"][i]))
        if "gs_means" in out:
            n = export_ply(os.path.join(d, "gaussians.ply"),
                           out["gs_means"], out["gs_covariances"],
                           out["gs_harmonics"], out["gs_opacities"],
                           min_opacity=0.01)
            print(f"scene{si:04d}: wrote {n} gaussians", flush=True)

    return hook


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
        predict = make_sharded_predict_fn(model, mesh, device,
                                          args.diagnostics)
    else:
        predict = make_predict_fn(model, device, args.diagnostics)
    # every rank holds every scene's prediction; rank 0 writes them
    vis_hook = (make_vis_hook(args.vis_dir, cfg)
                if args.vis_dir and (not dist.is_initialized()
                                     or dist.get_rank() == 0) else None)
    return evaluate_scenes(predict, scenes(cfg, args),
                           cfg.model.head.n_classes, device=device,
                           group_size=args.data_parallel, vis_hook=vis_hook)


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
