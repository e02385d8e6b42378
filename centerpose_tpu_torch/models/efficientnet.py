"""EfficientNet-B0 backbone with BiFPN fusion to stride 4.

Counterpart of ``centerpose_tpu/models/efficientnet.py``: the B0 trunk
(``MBConv``: expand 1x1, depthwise kxk, SiLU, squeeze-excite, project 1x1),
the stride-4/8/16/32 features projected to ``fpn_ch`` by 1x1 ``ConvBN``
(``lat{i}``), two ``BiFPNLayer`` passes (``bifpn{r}``), and the heads on the
stride-4 level.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import (ConvBN, HeadStack,
                                                add_numbered,
                                                upsample_nearest)
from centerpose_tpu_torch.models.mobilenet import SqueezeExcite


class MBConv(nn.Module):
    def __init__(self, in_features: int, features: int, expand_ratio: int,
                 kernel: int = 3, stride: int = 1):
        super().__init__()
        hidden = in_features * expand_ratio
        self.residual = stride == 1 and in_features == features
        expand = None
        if expand_ratio != 1:
            expand = add_numbered(self, "ConvBN", ConvBN(
                in_features, hidden, 1, 1, relu=False))
        depthwise = add_numbered(self, "ConvBN", ConvBN(
            hidden, hidden, kernel, stride, relu=False, groups=hidden))
        se = add_numbered(self, "SqueezeExcite",
                          SqueezeExcite(hidden, reduce=4 * expand_ratio))
        project = add_numbered(self, "ConvBN", ConvBN(hidden, features, 1, 1,
                                                      relu=False))
        # the registered children in call order (a list registers nothing)
        self.parts = [expand, depthwise, se, project]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        expand, depthwise, se, project = self.parts
        y = x if expand is None else F.silu(expand(x))
        y = project(se(F.silu(depthwise(y))))
        return y + x if self.residual else y


# (expand, out_ch, repeats, stride, kernel): B0
_B0_CFG = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
           (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
           (6, 320, 1, 1, 3)]


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``: the
    output ceil(n / 2) per side, the padding split low = total // 2 (the
    extra row or column at the end), padded with -inf."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class BiFPNLayer(nn.Module):
    """One bidirectional FPN pass over per-level features (fine -> coarse,
    all ``fpn_ch``): top-down, then bottom-up; every fused edge is weighted
    by the softplus of a learned parameter (``td{i}`` / ``bu{i}``, ones at
    init) normalised over the inputs, then SiLU and a 3x3 ``ConvBN``
    (``td{i}_conv`` / ``bu{i}_conv``)."""

    def __init__(self, fpn_ch: int, levels: int = 4):
        super().__init__()
        self.levels = levels
        # kept in f32 by ``to_compute_dtype``, as the reference declares them
        self.float32_params = tuple(
            [f"td{i}" for i in range(levels - 1)]
            + [f"bu{i}" for i in range(1, levels)])
        for i in range(levels - 2, -1, -1):
            self._edge(f"td{i}", 2, fpn_ch)
        for i in range(1, levels):
            self._edge(f"bu{i}", 3 if i < levels - 1 else 2, fpn_ch)

    def _edge(self, name: str, n_inputs: int, fpn_ch: int) -> None:
        self.register_parameter(name, nn.Parameter(torch.ones(n_inputs)))
        self.add_module(f"{name}_conv", ConvBN(fpn_ch, fpn_ch, 3, 1,
                                               relu=False))

    def _fuse(self, name: str, inputs: List[torch.Tensor]) -> torch.Tensor:
        # as the reference: f32 weights promote the sum to f32; the conv
        # takes it back in the compute dtype
        w = F.softplus(getattr(self, name).float())
        w = w / (w.sum() + 1e-4)
        y = sum(wi * t.float() for wi, t in zip(w, inputs))
        y = F.silu(y).to(inputs[0].dtype)
        return getattr(self, f"{name}_conv")(y)

    def forward(self, ps: List[torch.Tensor]) -> List[torch.Tensor]:
        n = self.levels
        td = [None] * n
        td[n - 1] = ps[n - 1]
        for i in range(n - 2, -1, -1):
            td[i] = self._fuse(f"td{i}", [ps[i], upsample_nearest(td[i + 1])])
        out = [td[0]] + [None] * (n - 1)
        for i in range(1, n):
            down = _max_pool_same(out[i - 1])
            ins = [ps[i], td[i], down] if i < n - 1 else [ps[i], down]
            out[i] = self._fuse(f"bu{i}", ins)
        return out


class PoseEfficientNet(nn.Module):
    """Takes NHWC images [B, H, W, 3]; returns NHWC float32 head maps at
    stride 4."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 64,
                 fpn_ch: int = 64, fpn_repeats: int = 2):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, 2, relu=False)
        self.stages = []  # (the stage's input is a feature, its blocks)
        cin, feats = 32, []
        for t, c, n, s, k in _B0_CFG:
            if s == 2:
                feats.append(cin)
            blocks = []
            for i in range(n):
                blocks.append(add_numbered(self, "MBConv", MBConv(
                    cin, c, t, k, s if i == 0 else 1)))
                cin = c
            self.stages.append((s == 2, blocks))
        feats = (feats + [cin])[1:]  # channels at strides 4, 8, 16, 32
        for i, f in enumerate(feats):
            self.add_module(f"lat{i}", ConvBN(f, fpn_ch, 1, 1))
        self.fpn_repeats = fpn_repeats
        for r in range(fpn_repeats):
            self.add_module(f"bifpn{r}", BiFPNLayer(fpn_ch, len(feats)))
        self.HeadStack_0 = HeadStack(fpn_ch, heads, head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.silu(self.ConvBN_0(x))
        feats = []  # the input of each strided stage, then the last output
        for strided, blocks in self.stages:
            if strided:
                feats.append(x)
            for m in blocks:
                x = m(x)
        feats = (feats + [x])[1:]  # drop stride 2: strides 4, 8, 16, 32
        ps = [getattr(self, f"lat{i}")(f) for i, f in enumerate(feats)]
        for r in range(self.fpn_repeats):
            ps = getattr(self, f"bifpn{r}")(ps)
        return self.HeadStack_0(ps[0])
