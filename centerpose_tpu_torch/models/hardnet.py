"""HarDNet (Harmonic DenseNet) backbone with upsampling to stride 4.

Counterpart of ``centerpose_tpu/models/hardnet.py``: a HarDNet-68-style
trunk of harmonic dense blocks (layer i reads layers i - 2^k for every 2^k
dividing i, growth multiplier 1.7; the block's output concatenates layer
0, the odd layers and the last), each followed by a 1x1 ``ConvBN``
transition (``trans{i}``) and, but for the last, a 2x2 max-pool; then the
three ``DeconvBN`` stages of ``mobilenet.PoseUpsample`` and the heads.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import ConvBN, HeadStack
from centerpose_tpu_torch.models.mobilenet import PoseUpsample


def _hard_link(layer: int, base_ch: int, gr: int,
               grmul: float) -> Tuple[int, List[int]]:
    """(out_channels, links) of a harmonic dense layer (the public HarDNet
    rule, as the reference computes it)."""
    if layer == 0:
        return base_ch, []
    out_ch = float(gr)
    links = []
    for i in range(10):
        dv = 2 ** i
        if layer % dv == 0:
            links.append(layer - dv)
            if i > 0:
                out_ch *= grmul
    out_ch = int(int(out_ch + 1) / 2) * 2
    return out_ch, sorted(links)


class HarDBlock(nn.Module):
    """Layers ``l1`` .. ``l{n_layers}``, each a 3x3 ``ConvBN`` over the
    concatenation of its links."""

    def __init__(self, in_features: int, growth: int, n_layers: int,
                 grmul: float = 1.7):
        super().__init__()
        self.links = [[]]
        chans = [in_features]
        for i in range(1, n_layers + 1):
            out_ch, links = _hard_link(i, in_features, growth, grmul)
            self.add_module(f"l{i}", ConvBN(sum(chans[l] for l in links),
                                            out_ch, 3, 1))
            self.links.append(links)
            chans.append(out_ch)
        self.keep = [i for i in range(n_layers + 1)
                     if i == n_layers or i % 2 == 1 or i == 0]
        self.out_features = sum(chans[i] for i in self.keep)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = [x]
        for i in range(1, len(self.links)):
            inp = torch.cat([layers[l] for l in self.links[i]], 1)
            layers.append(getattr(self, f"l{i}")(inp))
        return torch.cat([layers[i] for i in self.keep], 1)


class PoseHardNet(nn.Module):
    """Takes NHWC images [B, H, W, 3]; returns NHWC float32 head maps at
    stride 4."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 64,
                 ch_list: Sequence[int] = (128, 256, 320, 640),
                 growth: Sequence[int] = (14, 16, 20, 40),
                 n_layers: Sequence[int] = (8, 16, 16, 16),
                 down: Sequence[int] = (1, 1, 1, 0)):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, 2)
        self.ConvBN_1 = ConvBN(32, 64, 3, 1)
        self.down = tuple(down)
        cin = 64
        for i, (c, g, n) in enumerate(zip(ch_list, growth, n_layers)):
            block = HarDBlock(cin, g, n)
            self.add_module(f"block{i}", block)
            self.add_module(f"trans{i}", ConvBN(block.out_features, c, 1, 1))
            cin = c
        self._PoseUpsample_0 = PoseUpsample(cin)
        self.HeadStack_0 = HeadStack(self._PoseUpsample_0.out_features, heads,
                                     head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(self.ConvBN_1(self.ConvBN_0(x)), 3, 2, 1)
        for i, d in enumerate(self.down):
            x = getattr(self, f"trans{i}")(getattr(self, f"block{i}")(x))
            if d:
                x = F.max_pool2d(x, 2, 2)
        return self.HeadStack_0(self._PoseUpsample_0(x))
