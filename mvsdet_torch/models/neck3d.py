"""Indoor 3D voxel neck (port of mvsdet_tpu/models/neck3d.py).

`IndoorImVoxelNeck` (imvoxel_neck.py:70-170): three scales of residual 3D
blocks with stride-2 downsampling, top-down 2x transposed-conv fusion, a
3x3x3 out-block per scale.  Input (1, C, nx, ny, nz); returns three
levels, finest first, at `out_channels`.  BatchNorm takes the batch's
statistics and updates its running ones when `train` is set, as flax's
does, and the running statistics otherwise.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from mvsdet_torch.models.layers import ConvBnReLU, DeconvBnReLU


class ResModule3D(nn.Module):
    """3D residual block (imvoxel_neck.py:173-220)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBnReLU(in_channels, features, stride=stride,
                                dtype=dtype)
        self.conv2 = ConvBnReLU(features, features, relu=False, dtype=dtype)
        self.has_downsample = stride != 1 or in_channels != features
        if self.has_downsample:
            self.downsample = ConvBnReLU(in_channels, features, kernel=1,
                                         stride=stride, relu=False,
                                         dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv2(self.conv1(x, train), train)
        if self.has_downsample:
            x = self.downsample(x, train)
        return torch.relu(x + y)


class IndoorImVoxelNeck(nn.Module):
    def __init__(self, in_channels: int = 256, out_channels: int = 128,
                 n_blocks: Sequence[int] = (1, 1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks = tuple(n_blocks)
        n_scales = len(n_blocks)
        chans = []
        n_ch = in_channels
        for i in range(n_scales):
            stride = 1 if i == 0 else 2
            in_ch = n_ch
            if stride != 1:
                n_ch *= 2
            for b in range(n_blocks[i]):
                self.add_module(f"down{i}_block{b}",
                                ResModule3D(in_ch, n_ch,
                                            stride if b == 0 else 1, dtype))
                in_ch = n_ch
            chans.append(n_ch)
        for i in range(n_scales - 1, -1, -1):
            if i < n_scales - 1:
                c = chans[i + 1]
                self.add_module(f"up{i + 1}_deconv",
                                DeconvBnReLU(c, c // 2, kernel=2,
                                             dtype=dtype))
                self.add_module(f"up{i + 1}_conv",
                                ConvBnReLU(c // 2, c // 2, dtype=dtype))
            self.add_module(f"out{i}", ConvBnReLU(chans[i], out_channels,
                                                  dtype=dtype))

    def forward(self, x: torch.Tensor,
                train: bool = False) -> List[torch.Tensor]:
        n_scales = len(self.n_blocks)
        down_outs = []
        for i in range(n_scales):
            for b in range(self.n_blocks[i]):
                x = getattr(self, f"down{i}_block{b}")(x, train)
            down_outs.append(x)
        outs = []
        for i in range(n_scales - 1, -1, -1):
            if i < n_scales - 1:
                x = getattr(self, f"up{i + 1}_deconv")(x, train)
                x = getattr(self, f"up{i + 1}_conv")(x, train)
                x = down_outs[i] + x
            outs.append(getattr(self, f"out{i}")(x, train))
        return outs[::-1]
