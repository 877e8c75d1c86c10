# Frozen copy of mvsdet_torch/training/optim.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Optimizer, schedule and gradient clip (port of
mvsdet_tpu/training/optim.py).

The reference recipe (mvsdet_res50_2x_low_res_depth.py:179-193): AdamW lr
2e-4, weight decay 1e-4 on every parameter (optax decays all leaves),
backbone lr x0.1, stem and layer1 frozen (frozen_stages=1), global-norm
gradient clip 35, MultiStepLR x0.1 at epochs (8, 11), counted in steps and
stepped once per step.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn

from benchmark.reference.config import OptimConfig

def param_label(name: str, param: nn.Parameter) -> str:
    """The optimizer group of a parameter: frozen (it takes no gradient;
    the backbone's stages up to ``frozen_stages``, which `ResNet50`
    marks), backbone or default (the labels of `param_labels`,
    mvsdet_tpu/training/optim.py:21-33)."""
    if not param.requires_grad:
        return "frozen"
    return "backbone" if name.split(".")[0] == "backbone" else "default"


def build_optimizer(cfg: OptimConfig, model: nn.Module,
                    steps_per_epoch: int = 1000
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.MultiStepLR]:
    """AdamW over the default and backbone groups (the frozen group takes
    no update and is left out), and its MultiStepLR scheduler."""
    groups = {"default": [], "backbone": [], "frozen": []}
    for name, param in model.named_parameters():
        groups[param_label(name, param)].append(param)
    optimizer = torch.optim.AdamW(
        [{"params": groups["default"], "lr": cfg.lr},
         {"params": groups["backbone"],
          "lr": cfg.lr * cfg.backbone_lr_mult}],
        lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, [m * steps_per_epoch for m in cfg.milestones], cfg.gamma)
    return optimizer, scheduler


def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax `clip_by_global_norm`, in place on the parameters' gradients:
    scaled by max_norm / g_norm where g_norm >= max_norm, left as they are
    otherwise (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`).
    Reads nothing back to the host.  Returns g_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = g_norm < max_norm
    one = torch.ones_like(g_norm)
    # t / g_norm * max_norm, rounded as optax rounds it
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return g_norm
