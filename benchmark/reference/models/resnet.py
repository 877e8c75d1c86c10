# Frozen copy of mvsdet_torch/models/resnet.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""ResNet-50 backbone with frozen batch norm (port of
mvsdet_tpu/models/resnet.py).

torchvision-style ResNet-50, 'pytorch' blocks (stride on the 3x3), every
BN frozen, four stages out (C2..C5 at strides 4/8/16/32).  Submodule
names follow the JAX parameter tree (`stem_conv`, `layer1_block0.conv1`,
...).  `frozen_stages=1` freezes the stem and layer1: their parameters
take no gradient and layer1's output is detached, so no backward runs
through them (mvsdet_tpu/models/resnet.py:100-103).
`load_torchvision_checkpoint` and `port_torchvision_state_dict` read
ImageNet weights saved under torchvision's names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.models.layers import Conv2d, FrozenBatchNorm

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with frozen BN."""

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * 4
        self.conv1 = Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.has_downsample = in_channels != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_channels, out_ch, 1, stride,
                                          bias=False)
            self.downsample_bn = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """Returns (C2, C3, C4, C5) from (N, 3, H, W) images."""

    def __init__(self, depth: int = 50, frozen_stages: int = 1):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.stem_conv = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.stem_bn = FrozenBatchNorm(64)
        self.stages = []
        in_ch, width = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, Bottleneck(in_ch, width, stride))
                names.append(name)
                in_ch = width * 4
            self.stages.append(names)
            width *= 2
        frozen = ("stem_",) + tuple(f"layer{i + 1}_"
                                    for i in range(frozen_stages))
        for name, param in self.named_parameters():
            if frozen_stages > 0 and name.startswith(frozen):
                param.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = torch.relu(self.stem_bn(self.stem_conv(x)))
        x = nn.functional.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage < self.frozen_stages:
                x = x.detach()      # both this output and the next stage
            outs.append(x)
        return tuple(outs)


def load_torchvision_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a torchvision-format checkpoint file into a flat name -> tensor
    dict (mvsdet_tpu/models/resnet.py:109-125).

    Accepts a torch-saved ``.pth``/``.pt`` (optionally wrapped in a
    ``state_dict`` key, as mm checkpoints are) or a numpy ``.npz`` with
    torchvision parameter names: the file the reference downloads as
    ``torchvision://resnet50`` (ref: projects/NeRF-Det/configs/
    mvsdet_res50_2x_low_res_depth.py:25).
    """
    if path.endswith(".npz"):
        with np.load(path) as npz:
            return {k: torch.from_numpy(npz[k]) for k in npz.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def port_torchvision_state_dict(state_dict: Dict[str, torch.Tensor],
                                depth: int = 50) -> Dict[str, torch.Tensor]:
    """torchvision ResNet names -> this module's state-dict names
    (mvsdet_tpu/models/resnet.py:128-174).

    The layouts agree (OIHW convolutions; a frozen BN keeps torchvision's
    weight, bias, running_mean and running_var), so only the names change:
    ``conv1``/``bn1`` -> ``stem_conv``/``stem_bn``, ``layer{s}.{b}.`` ->
    ``layer{s}_block{b}.``, ``downsample.0``/``.1`` ->
    ``downsample_conv``/``downsample_bn``.  BN's ``num_batches_tracked``
    (nothing reads it) is dropped; a name the mapping expects and the
    dict lacks raises KeyError.
    """
    bn_keys = ("weight", "bias", "running_mean", "running_var")
    names = {"stem_conv.weight": "conv1.weight"}
    names.update({f"stem_bn.{k}": f"bn1.{k}" for k in bn_keys})
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n_blocks):
            tv, ours = f"layer{stage + 1}.{b}", f"layer{stage + 1}_block{b}"
            for i in (1, 2, 3):
                names[f"{ours}.conv{i}.weight"] = f"{tv}.conv{i}.weight"
                names.update({f"{ours}.bn{i}.{k}": f"{tv}.bn{i}.{k}"
                              for k in bn_keys})
            if f"{tv}.downsample.0.weight" in state_dict:
                names[f"{ours}.downsample_conv.weight"] = \
                    f"{tv}.downsample.0.weight"
                names.update({f"{ours}.downsample_bn.{k}":
                              f"{tv}.downsample.1.{k}" for k in bn_keys})
    return {ours: torch.as_tensor(state_dict[tv]) for ours, tv in names.items()}
