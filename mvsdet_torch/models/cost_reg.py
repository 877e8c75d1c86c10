"""Cost-volume regularisation 3D U-Net (port of mvsdet_tpu/models/cost_reg.py).

`CostRegNet_3DGS` (mvs_models/mvsnet.py:73-113): 2-down/2-up 3D U-Net
over the (D, H, W) variance volume, emitting 2 channels (depth cost and
per-plane offset).  Input (N, C, D, H, W), output (N, 2, D, H, W).
In the default "group" norm, train and eval compute the same function.
"""

from __future__ import annotations

import torch
from torch import nn

from mvsdet_torch.models.layers import Conv3d, ConvBnReLU, DeconvBnReLU


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int = 256, base: int = 64,
                 norm: str = "group", dtype: torch.dtype = torch.float32):
        super().__init__()
        b = base
        kw = dict(norm=norm, dtype=dtype)
        self.conv0 = ConvBnReLU(in_channels, b, **kw)
        self.conv1 = ConvBnReLU(b, b * 2, stride=2, **kw)
        self.conv2 = ConvBnReLU(b * 2, b * 2, **kw)
        self.conv3 = ConvBnReLU(b * 2, b * 4, stride=2, **kw)
        self.conv4 = ConvBnReLU(b * 4, b * 4, **kw)
        self.conv9 = DeconvBnReLU(b * 4, b * 2, **kw)
        self.conv11 = DeconvBnReLU(b * 2, b, **kw)
        self.prob = Conv3d(b, 2, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv0 = self.conv0(x, train)
        conv2 = self.conv2(self.conv1(conv0, train), train)
        bottom = self.conv4(self.conv3(conv2, train), train)
        x = conv2 + self.conv9(bottom, train)
        x = conv0 + self.conv11(x, train)
        return self.prob(x)
