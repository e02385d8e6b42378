"""HRNet-W32/W48 backbone (high-resolution parallel branches).

Counterpart of ``centerpose_tpu/models/hrnet.py``: a stride-4 stem (two
3x3 s2 ``ConvBN``), stage 1 of four bottlenecks, then three
multi-resolution stages (2/3/4 parallel branches of 4 ``BasicBlock`` at
widths W * 2^i) with a full fuse after every module: coarse -> fine is a
1x1 ``ConvBN`` then a nearest upsample, fine -> coarse a chain of strided
3x3 ``ConvBN``.  The heads read the stride-4 branch.  Submodules carry the
reference's explicit names (``stem1``, ``layer1_{b}``, ``trans1_0``,
``stage2_m{m}``, ``branch{i}_block{b}``, ``fuse_{i}_{j}[_{s}]``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from centerpose_tpu_torch.models.common import (ConvBN, HeadStack,
                                                upsample_nearest)
from centerpose_tpu_torch.models.resnet import BasicBlock, Bottleneck


class HRModule(nn.Module):
    """One multi-resolution module: per-branch blocks, then the full fuse
    ``out_i = relu(sum_j T_ij(y_j))``."""

    def __init__(self, widths: Sequence[int], num_blocks: int = 4):
        super().__init__()
        self.widths = list(widths)
        self.num_blocks = num_blocks
        n = len(widths)
        for i, w in enumerate(widths):
            for b in range(num_blocks):
                self.add_module(f"branch{i}_block{b}", BasicBlock(w, w, 1))
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse_{i}_{j}", ConvBN(
                        widths[j], widths[i], 1, 1, relu=False))
                for s in range(i - j):  # j < i
                    last = s == i - j - 1
                    self.add_module(f"fuse_{i}_{j}_{s}", ConvBN(
                        widths[j], widths[i] if last else widths[j], 3, 2,
                        relu=not last))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.widths)
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.num_blocks):
                x = getattr(self, f"branch{i}_block{b}")(x)
            ys.append(x)
        outs = []
        for i in range(n):
            acc = None
            for j in range(n):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = upsample_nearest(getattr(self, f"fuse_{i}_{j}")(ys[j]),
                                         2 ** (j - i))
                else:
                    t = ys[j]
                    for s in range(i - j):
                        t = getattr(self, f"fuse_{i}_{j}_{s}")(t)
                acc = t if acc is None else acc + t
            outs.append(torch.relu(acc))
        return outs


class PoseHighResolutionNet(nn.Module):
    """HRNet trunk + heads on the stride-4 branch.  Takes NHWC images [B,
    H, W, 3]; returns NHWC float32 head maps at stride 4."""

    def __init__(self, width: int, heads: Dict[str, int], head_conv: int = 64,
                 stage_modules: Sequence[int] = (1, 4, 3)):
        super().__init__()
        w = [width, 2 * width, 4 * width, 8 * width]
        self.stage_modules = tuple(stage_modules)
        self.stem1 = ConvBN(3, 64, 3, 2)
        self.stem2 = ConvBN(64, 64, 3, 2)
        for b in range(4):
            self.add_module(f"layer1_{b}", Bottleneck(64 if b == 0 else 256,
                                                      64, 1))
        self.trans1_0 = ConvBN(256, w[0], 3, 1)
        self.trans1_1 = ConvBN(256, w[1], 3, 2)
        self.trans2_2 = ConvBN(w[1], w[2], 3, 2)
        self.trans3_3 = ConvBN(w[2], w[3], 3, 2)
        for stage, count in zip((2, 3, 4), self.stage_modules):
            for m in range(count):
                self.add_module(f"stage{stage}_m{m}", HRModule(w[:stage]))
        self.HeadStack_0 = HeadStack(w[0], heads, head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def _stage(self, stage: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        for m in range(self.stage_modules[stage - 2]):
            xs = getattr(self, f"stage{stage}_m{m}")(xs)
        return xs

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = self.stem2(self.stem1(x))
        for b in range(4):
            x = getattr(self, f"layer1_{b}")(x)
        xs = self._stage(2, [self.trans1_0(x), self.trans1_1(x)])
        xs = self._stage(3, xs + [self.trans2_2(xs[-1])])
        xs = self._stage(4, xs + [self.trans3_3(xs[-1])])
        return self.HeadStack_0(xs[0])
