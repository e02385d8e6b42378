"""ResNet backbones with deconv upsampling to stride 4 (plain convs, no DCN).

Counterpart of ``centerpose_tpu/models/resnet.py``: the ResNet-18/34/50/
101/152 trunk (7x7 s2 stem, 3x3 s2 max-pool, four stages), then three
``DeconvBN`` stages (256 filters each) from stride 32 back to stride 4, then
the shared heads.  Submodules carry the flax names (``Conv_0``,
``BatchNorm_0``, ``BasicBlock_{n}`` / ``Bottleneck_{n}`` numbered across
stages, ``DeconvBN_{n}``, ``HeadStack_0``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from centerpose_tpu_torch.models.common import (BatchNorm2d, Conv2d, ConvBN,
                                                DeconvBN, HeadStack,
                                                add_numbered, conv_bn,
                                                max_pool2d)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 3, strides)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, relu=False)
        self.ConvBN_2 = None
        if strides != 1 or in_features != features:
            self.ConvBN_2 = ConvBN(in_features, features, 1, strides,
                                   relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBN_1(self.ConvBN_0(x))
        residual = x if self.ConvBN_2 is None else self.ConvBN_2(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at ``features``; the output is 4x
    wider."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        out = features * 4
        self.ConvBN_0 = ConvBN(in_features, features, 1, 1)
        self.ConvBN_1 = ConvBN(features, features, 3, strides)
        self.ConvBN_2 = ConvBN(features, out, 1, 1, relu=False)
        self.ConvBN_3 = None
        if strides != 1 or in_features != out:
            self.ConvBN_3 = ConvBN(in_features, out, 1, strides, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        residual = x if self.ConvBN_3 is None else self.ConvBN_3(x)
        return torch.relu(y + residual)


RESNET_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class PoseResNet(nn.Module):
    """ResNet trunk + 3-stage deconv + heads.  Takes NHWC images [B, H, W,
    3]; returns NHWC float32 head maps at stride 4."""

    def __init__(self, num_layers: int, heads: Dict[str, int],
                 head_conv: int = 64,
                 deconv_filters: Sequence[int] = (256, 256, 256)):
        super().__init__()
        block, layers = RESNET_SPECS[num_layers]
        self.Conv_0 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        nn.init.kaiming_normal_(self.Conv_0.weight)
        self.BatchNorm_0 = BatchNorm2d(64)
        self.blocks = []
        cin = 64
        for stage, (w, n) in enumerate(zip((64, 128, 256, 512), layers)):
            for i in range(n):
                strides = 2 if (stage > 0 and i == 0) else 1
                self.blocks.append(add_numbered(
                    self, block.__name__, block(cin, w, strides)))
                cin = w * block.expansion
        self.deconvs = []
        for f in deconv_filters:
            self.deconvs.append(add_numbered(self, "DeconvBN",
                                             DeconvBN(cin, f)))
            cin = f
        self.HeadStack_0 = HeadStack(cin, heads, head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(conv_bn(self.Conv_0, self.BatchNorm_0, x))
        # flax's max_pool pads with -inf, as max_pool2d does
        x = max_pool2d(x, 3, 2, 1)
        for m in self.blocks + self.deconvs:
            x = m(x)
        return self.HeadStack_0(x)
