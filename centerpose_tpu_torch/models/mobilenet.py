"""MobileNetV2 / V3 backbones with light deconv upsampling to stride 4.

Counterpart of ``centerpose_tpu/models/mobilenet.py``: an inverted-residual
trunk (V3 adds squeeze-excite and h-swish), three ``DeconvBN`` stages
(256, 128, 64 filters) back to stride 4, then the shared heads.  Depthwise
convs are ``ConvBN`` with ``groups`` equal to the channels.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import (Conv2d, ConvBN, DeconvBN,
                                                HeadStack, add_numbered)


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


class SqueezeExcite(nn.Module):
    """Spatial mean -> 1x1 conv (bias) -> ReLU -> 1x1 conv (bias) ->
    h-sigmoid gate on x."""

    def __init__(self, channels: int, reduce: int = 4):
        super().__init__()
        mid = max(8, channels // reduce)
        self.Conv_0 = Conv2d(channels, mid, 1)
        self.Conv_1 = Conv2d(mid, channels, 1)
        for conv in (self.Conv_0, self.Conv_1):
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = self.Conv_1(torch.relu(self.Conv_0(s)))
        return x * h_sigmoid(s)


class InvertedResidual(nn.Module):
    """Expand 1x1 (when ``expand`` differs from the input) -> depthwise
    kxk -> (SE) -> project 1x1; the residual where shapes allow."""

    def __init__(self, in_features: int, features: int, expand: int,
                 kernel: int = 3, stride: int = 1, use_se: bool = False,
                 use_hs: bool = False):
        super().__init__()
        self.act = h_swish if use_hs else torch.relu
        self.residual = stride == 1 and in_features == features
        expand_bn = None
        if expand != in_features:
            expand_bn = add_numbered(self, "ConvBN", ConvBN(
                in_features, expand, 1, 1, relu=False))
        depthwise = add_numbered(self, "ConvBN", ConvBN(
            expand, expand, kernel, stride, relu=False, groups=expand))
        se = (add_numbered(self, "SqueezeExcite", SqueezeExcite(expand))
              if use_se else None)
        project = add_numbered(self, "ConvBN", ConvBN(expand, features, 1, 1,
                                                      relu=False))
        # the registered children in call order (a list registers nothing)
        self.parts = [expand_bn, depthwise, se, project]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        expand_bn, depthwise, se, project = self.parts
        y = x if expand_bn is None else self.act(expand_bn(x))
        y = depthwise(y)
        if se is not None:
            y = se(y)
        y = project(self.act(y))
        return y + x if self.residual else y


class PoseUpsample(nn.Module):
    """Three DeconvBN stages: stride 32 -> 4 (the reference's
    ``_PoseUpsample``; filters 256, 128, 64)."""

    def __init__(self, in_features: int,
                 filters: Sequence[int] = (256, 128, 64)):
        super().__init__()
        self.stages = []
        for f in filters:
            self.stages.append(add_numbered(self, "DeconvBN",
                                            DeconvBN(in_features, f)))
            in_features = f
        self.out_features = in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.stages:
            x = m(x)
        return x


# (expand_ratio, out_ch, repeats, stride)
_V2_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

# (kernel, expand_dim, out_ch, SE, h-swish, stride): MobileNetV3-Large
_V3_CFG = [
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]


class _PoseMobileNet(nn.Module):
    """Stem ``ConvBN_0`` -> inverted residuals -> ``_PoseUpsample_0`` ->
    heads.  Takes NHWC images [B, H, W, 3]; returns NHWC float32 head maps
    at stride 4."""

    def __init__(self, stem: int, blocks: list, heads: Dict[str, int],
                 head_conv: int, stem_act):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, stem, 3, 2, relu=False)
        self.stem_act = stem_act
        self.blocks = []
        cin = stem
        for kw in blocks:
            self.blocks.append(add_numbered(self, "InvertedResidual",
                                            InvertedResidual(cin, **kw)))
            cin = kw["features"]
        self._PoseUpsample_0 = PoseUpsample(cin)
        self.HeadStack_0 = HeadStack(self._PoseUpsample_0.out_features, heads,
                                     head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = self.stem_act(self.ConvBN_0(x))
        for m in self.blocks:
            x = m(x)
        return self.HeadStack_0(self._PoseUpsample_0(x))


class PoseMobileNetV2(_PoseMobileNet):
    def __init__(self, heads: Dict[str, int], head_conv: int = 64,
                 width_mult: float = 1.0):
        blocks, cin = [], int(32 * width_mult)
        for t, co, n, s in _V2_CFG:
            co = int(co * width_mult)
            for i in range(n):
                blocks.append(dict(features=co, expand=t * cin,
                                   stride=s if i == 0 else 1))
                cin = co
        super().__init__(int(32 * width_mult), blocks, heads, head_conv,
                         torch.relu)


class PoseMobileNetV3(_PoseMobileNet):
    def __init__(self, heads: Dict[str, int], head_conv: int = 64):
        blocks = [dict(features=co, expand=exp, kernel=k, stride=s,
                       use_se=se, use_hs=hs)
                  for k, exp, co, se, hs, s in _V3_CFG]
        super().__init__(16, blocks, heads, head_conv, h_swish)
