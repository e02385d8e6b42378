"""DLA-34 backbone with DCNv2 iterative-deep-aggregation upsampling.

Counterpart of ``centerpose_tpu/models/dla.py``: the DLA-34 trunk
(BasicBlock / Root / Tree, levels [1,1,1,2,2,1], channels
[16,32,64,128,256,512]) producing maps at strides 1..32; DLAUp/IDAUp
aggregation where every projection and node is DCNv2 (3x3) + BN + ReLU, and
2x/4x upsampling is a fixed bilinear depthwise transposed conv; six heads on
the stride-4 map.

Inside the model tensors are NCHW in ``channels_last`` memory, so the NHWC
DCN op takes them with a permute and no copy.  In eval mode every DCN site
runs the om-fused ``ops/dcn_cuda.dcn_v2_fused`` (K1) at the clamp radius
the reference's inference policy gives the site (``site_max_dy``).  In
train mode, as the reference with ``train=True``, it runs the offset/mask
conv as a conv in the compute dtype and then ``ops/dcn_cuda.dcn_v2`` (K2,
whose gradient is the backward kernel) at the training radius
(``train_site_max_dy``).  Each is the CUDA kernel for a CUDA tensor and
its plain version for a CPU tensor.  At 512x512 the 16 calls of one
forward go over 7 site shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import BatchNorm2d, ConvBN, HeadStack
from centerpose_tpu_torch.ops.dcn_cuda import (dcn_v2, dcn_v2_fused,
                                               site_max_dy, train_site_max_dy)


class _OffsetMaskParams(nn.Module):
    """Parameters of the offset/mask conv (``conv_offset_mask``), kept in the
    DCN op's layout: weight [3, 3, Cin, 27], bias [27].  Zero init: training
    starts from plain-conv behaviour."""

    def __init__(self, in_features: int, features: int = 27):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))


class DCN(nn.Module):
    """Modulated deformable conv module: offset/mask conv + DCNv2.  Weights
    are cast to the input's dtype at use; the bias stays float32
    (``float32_params``): the reference adds it in f32 before the cast to
    the output type."""

    float32_params = ("bias",)

    def __init__(self, in_features: int, features: int, dcn_impl: str = "xla",
                 max_dy: int = 0):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.dcn_impl = dcn_impl
        self.max_dy = max_dy
        self.weight = nn.Parameter(torch.empty(3, 3, in_features, features))
        nn.init.normal_(self.weight, std=float(np.sqrt(2.0 / (9 * in_features))))
        self.bias = nn.Parameter(torch.zeros(features))
        self.conv_offset_mask = _OffsetMaskParams(in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        dt = x.dtype
        site = (h, w, self.in_features, self.features, self.dcn_impl,
                self.max_dy)
        omw = self.conv_offset_mask.weight.to(dt)
        omb = self.conv_offset_mask.bias.to(dt)
        weight = self.weight.to(dt)
        xn = x.permute(0, 2, 3, 1).contiguous()
        if not self.training:
            y = dcn_v2_fused(xn, omw, omb, weight, self.bias,
                             site_max_dy(*site))
            return y.permute(0, 3, 1, 2)
        # the reference's train path: the om conv, rounded to the compute
        # dtype, then its bias in that dtype; offsets and the sigmoid-ed
        # mask stay in the compute dtype
        om = F.conv2d(x, omw.permute(3, 2, 0, 1), padding=1)
        om = om + omb.view(1, -1, 1, 1)
        om = om.permute(0, 2, 3, 1)
        offset = om[..., :18].contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        y = dcn_v2(xn, offset, mask, weight, self.bias,
                   train_site_max_dy(*site))
        return y.permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """DCN 3x3 -> BN -> ReLU."""

    def __init__(self, in_features: int, features: int, dcn_impl: str = "xla",
                 dcn_max_dy: int = 0):
        super().__init__()
        self.DCN_0 = DCN(in_features, features, dcn_impl, dcn_max_dy)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.DCN_0(x)))


def _bilinear_weights_1d(factor: int) -> np.ndarray:
    """1-D bilinear kernel of size 2*factor (one row of fill_up_weights)."""
    k = 2 * factor
    f = int(np.ceil(k / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    return np.array([1 - abs(i / f - c) for i in range(k)], dtype=np.float32)


def bilinear_kernel(channels: int, factor: int) -> torch.Tensor:
    """Depthwise transposed-conv weight [C, 1, 2f, 2f] of the fixed
    bilinear upsample (the outer product of the 1-D kernel)."""
    w1 = torch.from_numpy(_bilinear_weights_1d(factor))
    return torch.outer(w1, w1).expand(channels, 1, 2 * factor, 2 * factor).clone()


def bilinear_upsample(x: torch.Tensor, factor: int,
                      weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed depthwise bilinear upsample of an NCHW tensor: transposed conv
    with kernel 2f, stride f, padding f//2, groups=C (the frozen
    fill_up_weights of upstream).  ``weight``: a cached
    ``bilinear_kernel`` on x's device and dtype."""
    c = x.shape[1]
    if weight is None:
        weight = bilinear_kernel(c, factor).to(x.device, x.dtype)
    return F.conv_transpose2d(x, weight, stride=factor, padding=factor // 2,
                              groups=c)


class DlaBasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 3, stride)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, relu=False)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        return torch.relu(self.ConvBN_1(self.ConvBN_0(x)) + residual)


class Root(nn.Module):
    """Aggregation node: 1x1 conv over concat(children), ReLU (DLA-34 uses
    no root residual)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 1, 1, relu=False)

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        return torch.relu(self.ConvBN_0(torch.cat(children, dim=1)))


class Tree(nn.Module):
    """Recursive DLA tree.  ``root_dim`` is the channel count the root
    concatenates (computed as upstream's constructor does)."""

    def __init__(self, levels: int, in_features: int, features: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * features
        if level_root:
            root_dim += in_features
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if levels == 1:
            self.tree1 = DlaBasicBlock(in_features, features, stride)
            self.tree2 = DlaBasicBlock(features, features, 1)
            self.root = Root(root_dim, features)
        else:
            self.tree1 = Tree(levels - 1, in_features, features, stride)
            self.tree2 = Tree(levels - 1, features, features, 1,
                              root_dim=root_dim + features)
        if in_features != features:
            self.project = ConvBN(in_features, features, 1, 1, relu=False)
        else:
            self.project = None

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        proj = bottom
        if self.project is not None and (residual is None or self.training):
            # as the reference, project runs in train mode even where a
            # residual is given: its BatchNorm statistics advance
            proj = self.project(bottom)
        if residual is None:
            residual = proj
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x, residual)
        children.append(x1)
        return self.tree2(x1, None, children)


class DLATrunk(nn.Module):
    """DLA-34 trunk -> 6 feature maps at strides [1, 2, 4, 8, 16, 32]."""

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 levels: Sequence[int] = (1, 1, 1, 2, 2, 1)):
        super().__init__()
        ch = channels
        self.base_layer = ConvBN(3, ch[0], 7, 1)
        self.level0 = ConvBN(ch[0], ch[0], 3, 1)
        self.level1 = ConvBN(ch[0], ch[1], 3, 2)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = []
        x = self.level0(self.base_layer(x))
        y.append(x)
        for name in ("level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            y.append(x)
        return y


class IDAUp(nn.Module):
    """Iterative deep aggregation over layers[startp:endp]: for each deeper
    layer, DCN-project to ``features``, upsample by its factor, then
    DCN-node fuse with the shallower neighbour.  ``channels``: the input
    channel counts of layers[startp:endp]."""

    def __init__(self, features: int, channels: Sequence[int],
                 up_factors: Sequence[int], dcn_impl: str = "xla",
                 dcn_max_dy: int = 0):
        super().__init__()
        self.up_factors = [int(f) for f in up_factors]
        for i in range(1, len(channels)):
            self.add_module(f"proj_{i}", DeformConv(
                channels[i], features, dcn_impl, dcn_max_dy))
            self.add_module(f"node_{i}", DeformConv(
                features, features, dcn_impl, dcn_max_dy))
            f = self.up_factors[i]
            if f > 1:
                self.register_buffer(f"up_{i}", bilinear_kernel(features, f),
                                     persistent=False)

    def forward(self, layers: List[torch.Tensor], startp: int,
                endp: int) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(startp + 1, endp):
            j = i - startp
            p = getattr(self, f"proj_{j}")(layers[i])
            f = self.up_factors[j]
            if f > 1:
                up = getattr(self, f"up_{j}").to(p.dtype)
                p = bilinear_upsample(p, f, up)
            layers[i] = getattr(self, f"node_{j}")(p + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Progressive aggregation of trunk levels startp..5 down to stride 4."""

    def __init__(self, startp: int, channels: Sequence[int],
                 dcn_impl: str = "xla", dcn_max_dy: int = 0):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = [2 ** i for i in range(len(channels))]
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            up_f = [s // scales[j] for s in scales[j:]]
            self.add_module(f"ida_{i}", IDAUp(
                channels[j], in_channels[j:], up_f, dcn_impl, dcn_max_dy))
            for t in range(j + 1, 0):
                scales[t] = scales[j]
                in_channels[t] = channels[j]

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n):
            j = -i - 2
            layers = getattr(self, f"ida_{i}")(layers, len(layers) + j,
                                               len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """Full DLA-34 pose net: trunk -> DLAUp -> final IDAUp -> heads.
    Takes NHWC images [B, H, W, 3]; returns NHWC float32 head maps."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 256,
                 down_ratio: int = 4, last_level: int = 5,
                 dcn_impl: str = "xla", dcn_max_dy: int = 0):
        super().__init__()
        self.first_level = int(np.log2(down_ratio))
        self.last_level = last_level
        trunk = (16, 32, 64, 128, 256, 512)
        self.base = DLATrunk(trunk)
        self.dla_up = DLAUp(self.first_level, trunk[self.first_level:],
                            dcn_impl, dcn_max_dy)
        n = last_level - self.first_level
        self.ida_up = IDAUp(trunk[self.first_level],
                            trunk[self.first_level:last_level],
                            [2 ** i for i in range(n)], dcn_impl, dcn_max_dy)
        self.HeadStack_0 = HeadStack(trunk[self.first_level], heads, head_conv)
        self.compute_dtype = torch.float32  # see models/common.py

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        feats = self.base(x)
        outs = self.dla_up(feats)
        y = list(outs[: self.last_level - self.first_level])
        y = self.ida_up(y, 0, len(y))
        return self.HeadStack_0(y[-1])

