"""Darknet-53 backbone with upsampling to stride 4.

Counterpart of ``centerpose_tpu/models/darknet.py``: a 3x3/32 stem, then
five stages of (a strided 3x3 downsample, N residual units of a 1x1 to half
the channels and a 3x3 back) at 64..1024 channels with repeats (1, 2, 8,
8, 4), LeakyReLU(0.1) after every BatchNorm; then the three ``DeconvBN``
stages of ``mobilenet.PoseUpsample`` and the heads.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import ConvBN, HeadStack, add_numbered
from centerpose_tpu_torch.models.mobilenet import PoseUpsample


class DarkConv(ConvBN):
    """Conv (no bias) -> BN -> LeakyReLU(0.1): ``Conv_0`` and
    ``BatchNorm_0`` as in ``ConvBN``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__(in_features, features, kernel, stride, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(super().forward(x), 0.1)


class DarkResidual(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.DarkConv_0 = DarkConv(features, features // 2, 1, 1)
        self.DarkConv_1 = DarkConv(features // 2, features, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.DarkConv_1(self.DarkConv_0(x))


class PoseDarknet(nn.Module):
    """Takes NHWC images [B, H, W, 3]; returns NHWC float32 head maps at
    stride 4."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 64):
        super().__init__()
        self.layers = [add_numbered(self, "DarkConv", DarkConv(3, 32, 3, 1))]
        cin = 32
        for ch, n in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
            self.layers.append(add_numbered(self, "DarkConv",
                                            DarkConv(cin, ch, 3, 2)))
            self.layers += [add_numbered(self, "DarkResidual",
                                         DarkResidual(ch)) for _ in range(n)]
            cin = ch
        self._PoseUpsample_0 = PoseUpsample(cin)
        self.HeadStack_0 = HeadStack(self._PoseUpsample_0.out_features, heads,
                                     head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for m in self.layers:
            x = m(x)
        return self.HeadStack_0(self._PoseUpsample_0(x))
