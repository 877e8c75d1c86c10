# Frozen copy of mvsdet_torch/models/fpn.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Feature Pyramid Network (port of mvsdet_tpu/models/fpn.py).

Lateral 1x1 convs, nearest top-down upsampling to the exact lateral
shape, 3x3 output convs, four levels at 256 channels.  MVSDet consumes
level 0 (stride 4).  The top-down resize is JAX's nearest, half-pixel
centres (ROADMAP trap T3), not torch's legacy "nearest".
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from benchmark.reference.models.layers import Conv2d
from benchmark.reference.ops.sampling import nearest_resize


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.n_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}",
                            Conv2d(c, out_channels, 1))
            self.add_module(f"out{i}", Conv2d(out_channels, out_channels, 3,
                                              padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [getattr(self, f"lateral{i}")(x)
                    for i, x in enumerate(inputs)]
        for i in range(self.n_levels - 1, 0, -1):
            up = nearest_resize(laterals[i], laterals[i - 1].shape[2:],
                                (2, 3))
            laterals[i - 1] = laterals[i - 1] + up
        return tuple(getattr(self, f"out{i}")(x)
                     for i, x in enumerate(laterals))
