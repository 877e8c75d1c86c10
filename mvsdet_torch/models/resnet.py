"""ResNet-50 backbone with frozen batch norm (port of
mvsdet_tpu/models/resnet.py).

torchvision-style ResNet-50, 'pytorch' blocks (stride on the 3x3), every
BN frozen, four stages out (C2..C5 at strides 4/8/16/32).  Submodule
names follow the JAX parameter tree (`stem_conv`, `layer1_block0.conv1`,
...).  `frozen_stages=1` freezes the stem and layer1: their parameters
take no gradient and layer1's output is detached, so no backward runs
through them (mvsdet_tpu/models/resnet.py:100-103).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mvsdet_torch.models.layers import FrozenBatchNorm

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with frozen BN."""

    def __init__(self, in_channels: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * 4
        self.conv1 = nn.Conv2d(in_channels, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.has_downsample = in_channels != out_ch or stride != 1
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, out_ch, 1, stride,
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
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
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
