"""ShuffleNetV2 (1.0x) backbone with upsampling to stride 4.

Counterpart of ``centerpose_tpu/models/shufflenet.py``: a 3x3 s2 stem and a
3x3 s2 max-pool; three stages of channel-split units (stride 1: split the
channels in halves, process one, concatenate and shuffle; stride 2: both
branches strided, doubling the channels); a 1x1 ``ConvBN`` to 1024; the
three ``DeconvBN`` stages of ``mobilenet.PoseUpsample``; the heads.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import ConvBN, HeadStack, add_numbered
from centerpose_tpu_torch.models.mobilenet import PoseUpsample


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Output channel ``i * groups + g`` is input channel ``g * (C /
    groups) + i`` (the reference's NHWC reshape, swap and flatten)."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


class ShuffleUnit(nn.Module):
    """``features``: the unit's output channels."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        half = features // 2
        self.stride = stride
        if stride == 1:
            specs = [(half, half, 1, 1, 1, True), (half, half, 3, 1, half, False),
                     (half, half, 1, 1, 1, True)]
        else:
            c = in_features
            specs = [(c, c, 3, 2, c, False), (c, half, 1, 1, 1, True),
                     (c, half, 1, 1, 1, True), (half, half, 3, 2, half, False),
                     (half, half, 1, 1, 1, True)]
        for cin, cout, k, s, g, relu in specs:
            add_numbered(self, "ConvBN", ConvBN(cin, cout, k, s, relu=relu,
                                                groups=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = [getattr(self, f"ConvBN_{i}") for i in range(len(self._modules))]
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, conv[2](conv[1](conv[0](x2)))], 1)
        else:
            b1 = conv[1](conv[0](x))
            b2 = conv[4](conv[3](conv[2](x)))
            out = torch.cat([b1, b2], 1)
        return channel_shuffle(out, 2)


class PoseShuffleNetV2(nn.Module):
    """Takes NHWC images [B, H, W, 3]; returns NHWC float32 head maps at
    stride 4."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 64,
                 stage_channels: Sequence[int] = (116, 232, 464),
                 stage_repeats: Sequence[int] = (4, 8, 4)):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 24, 3, 2)
        self.units = []
        cin = 24
        for c, n in zip(stage_channels, stage_repeats):
            for i in range(n):
                self.units.append(add_numbered(self, "ShuffleUnit", ShuffleUnit(
                    cin, c, 2 if i == 0 else 1)))
                cin = c
        self.ConvBN_1 = ConvBN(cin, 1024, 1, 1)
        self._PoseUpsample_0 = PoseUpsample(1024)
        self.HeadStack_0 = HeadStack(self._PoseUpsample_0.out_features, heads,
                                     head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(self.ConvBN_0(x), 3, 2, 1)
        for m in self.units:
            x = m(x)
        return self.HeadStack_0(self._PoseUpsample_0(self.ConvBN_1(x)))
