"""DLA-34 backbone with DCNv2 iterative-deep-aggregation upsampling.

Counterpart of ``centerpose_tpu/models/dla.py``: the DLA-34 trunk
(BasicBlock / Root / Tree, levels [1,1,1,2,2,1], channels
[16,32,64,128,256,512]) producing maps at strides 1..32; DLAUp/IDAUp
aggregation where every projection and node is DCNv2 (3x3) + BN + ReLU, and
2x/4x upsampling is a fixed bilinear depthwise transposed conv; six heads on
the stride-4 map.

Inside the model tensors are NCHW in ``channels_last`` memory, so the NHWC
DCN op takes them with a permute and no copy.  In eval mode a DCN site
runs the om-fused ``ops/dcn_cuda.dcn_v2_fused`` (K1) where the reference
runs its om-fused kernel (``site_om_fused``: ``pallas``/``pallas_full``
inside the fused envelope, all 7 sites at 512x512), at the clamp radius the
reference's inference policy gives the site (``site_max_dy``).  Elsewhere
(every site under ``dcn_impl: xla``), and in train mode as the reference
with ``train=True``, it runs the offset/mask conv as a conv in the compute
dtype, rounded where the reference's compiled site rounds it, and then
``ops/dcn_cuda.dcn_v2`` (K2, whose gradient is the backward kernel) at the
training radius (``train_site_max_dy``); both backwards pass the clamp's
gradient at exactly +-R that the reference's backward dispatch gives the
site (``train_site_edge_grad``).  Each is the CUDA kernel for a CUDA tensor
and its plain version for a CPU tensor.  At 512x512 the 16 calls of one
forward go over 7 site shapes.  Under ``dcn_impl: conv``, the reference's
ablation, every site is a plain 3x3 conv (``DCN._plain_conv``).

On row shards (``parallel/spatial.py``) a site keeps the policy of the
whole image's height (``spatial.global_rows``): the same R and the same
kernel as one process, on shards of unequal heights too.  Its input gets
the rows its taps can reach from the neighbouring shards (``_site_rows``):
R + 1 above and below at a clamped site (``clamped_halo``), and at an
unclamped one as many as the offsets of this forward reach, agreed over
the shards (``unclamped_halo``); the rows of the output computed on that
halo are cropped.  A shard with no rows takes part in every exchange and
launches no kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from centerpose_tpu_torch.models.common import (BatchNorm2d, ConvBN, HeadStack,
                                                _ConvF32, _narrow, bilinear_1d,
                                                max_pool2d, tf32_convs)
from centerpose_tpu_torch.ops.dcn_cuda import (dcn_v2, dcn_v2_fused,
                                               site_max_dy, site_om_fused,
                                               train_site_edge_grad,
                                               train_site_max_dy)
from centerpose_tpu_torch.parallel import spatial

# the rows a 3x3 conv with padding 1 reads
_CONV3 = spatial.Window(3, 1, 1, (1, 1))


class _OffsetMaskParams(nn.Module):
    """Parameters of the offset/mask conv (``conv_offset_mask``), kept in the
    DCN op's layout: weight [3, 3, Cin, 27], bias [27].  Zero init: training
    starts from plain-conv behaviour."""

    def __init__(self, in_features: int, features: int = 27):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))


def clamped_halo(max_dy: int) -> int:
    """Rows above and below an output row that a DCN site clamped at
    ``max_dy`` reads: tap row -1..1 plus dy in [-R, R], and the bilinear
    corner below a fractional position (``tap_corners`` in
    csrc/dcn_fused.cu: rows floor(sy) and floor(sy) + 1, the second with
    weight 0 where sy is a whole row), so R + 1.  The om conv of K1 reads
    one row each way, inside it."""
    return int(max_dy) + 1


def unclamped_halo(offset: torch.Tensor, limit: int) -> tuple:
    """(above, below): the rows the unclamped taps of ``offset`` [B, h, W,
    18] (dy at even channels) read above and below their output rows,
    the largest over the spatial group: 1 - floor(min dy) above and 2 +
    floor(max dy) below (tap row +-1, the corner below), at least 0, at
    most ``limit`` (the rest of the image), and ``limit`` where an offset
    is not finite; 0 on a shard with no rows."""
    dy = offset[..., 0::2].float()
    if dy.numel():
        need = torch.stack([1 - torch.floor(dy.min()),
                            2 + torch.floor(dy.max())])
        need = torch.nan_to_num(need, nan=limit, posinf=limit, neginf=limit)
        need = need.clamp(0, limit)
    else:  # a shard with no rows needs none
        need = dy.new_zeros(2)
    sh = spatial.active()
    dist.all_reduce(need, op=dist.ReduceOp.MAX, group=sh.group)
    above, below = (int(v) for v in need.tolist())
    return above, below


def _site_rows(x: torch.Tensor, above: int, below: int) -> tuple:
    """(rows, start): this shard's rows of the NCHW ``x`` with ``above``
    and ``below`` more from the neighbours, cut at the image's top and
    bottom (a DCN samples zero outside the image, as past the rows'
    ends: the whole image's bottom, also on a shorter shard), and where
    the shard's own rows start in them."""
    sh = spatial.active()
    h = x.shape[2]
    heights = sh.heights(h, x.shape[3])
    first = sum(heights[:sh.index])
    rows = spatial.halo(x, above, below)
    cut_top = max(0, above - first)
    cut_bottom = max(0, first + h + below - sum(heights))
    return rows[:, :, cut_top:rows.shape[2] - cut_bottom], above - cut_top


def _no_rows(x: torch.Tensor, features: int) -> torch.Tensor:
    """A site's output on a shard with no rows of the NCHW ``x``."""
    b, _, _, w = x.shape
    return x.new_zeros((b, 0, w, features)).permute(0, 3, 1, 2)


def _crop(y: torch.Tensor, start: int, h: int) -> torch.Tensor:
    """The ``h`` rows of the NHWC ``y`` from ``start`` (all of it where
    they are all of it)."""
    return y if start == 0 and y.shape[1] == h else y[:, start:start + h]


def _sigmoid(z: torch.Tensor, training: bool) -> torch.Tensor:
    """The mask's sigmoid.  At inference, ``1 / (1 + exp(-z))`` one op at a
    time, so that a bf16 ``z`` is rounded after the exp and after the add
    as XLA rounds ``jax.nn.sigmoid`` in the reference's compiled site; in
    training ``torch.sigmoid`` (one rounding, and a gradient that stays
    finite where exp(-z) overflows)."""
    if training:
        return torch.sigmoid(z)
    return torch.reciprocal(torch.exp(-z) + 1)


class DCN(nn.Module):
    """Modulated deformable conv module: offset/mask conv + DCNv2.  Weights
    are cast to the input's dtype at use; the bias stays float32
    (``float32_params``): the reference adds it in f32 before the cast to
    the output type.

    ``dcn_impl="conv"`` is the reference's ablation: a plain 3x3 conv with
    the DCN's weight and bias and no offset/mask parameters (not a DCN, and
    no hand kernel).  In bf16 it returns the f32 sum of the conv and the
    bias, the conv computed in f32 on the bf16 values (``_ConvF32``): in
    the reference's compiled bf16 graph XLA drops the conv's rounding
    before the f32 bias add, as at a ``ConvBN``
    (``tests/test_torch_dcn_conv.py``)."""

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
        if dcn_impl != "conv":
            self.conv_offset_mask = _OffsetMaskParams(in_features)

    def _plain_conv(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.permute(3, 2, 0, 1)  # [3, 3, Cin, Cout] -> OIHW
        if _narrow(x.dtype):
            y = spatial.window(x, _CONV3, lambda t, rows: _ConvF32.apply(
                t, w, False, (1, 1), (rows[0], 1), (1, 1), (0, 0), 1))
        else:
            y = spatial.window(x, _CONV3, lambda t, rows: F.conv2d(
                t, w.to(x.dtype), padding=(rows[0], 1)))
        return y + self.bias.view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dcn_impl == "conv":
            return self._plain_conv(x)
        _, _, h, w = x.shape
        dt = x.dtype
        site = (spatial.global_rows(x), w, self.in_features, self.features,
                self.dcn_impl, self.max_dy)
        omw = self.conv_offset_mask.weight.to(dt)
        omb = self.conv_offset_mask.bias.to(dt)
        weight = self.weight.to(dt)
        sharded = spatial.active() is not None
        if not self.training and site_om_fused(*site):
            r = site_max_dy(*site)
            xs, start = x, 0
            if sharded:
                xs, start = _site_rows(x, clamped_halo(r), clamped_halo(r))
            if not h:  # a shard with no rows: the exchange, no kernel
                return _no_rows(x, self.features)
            y = dcn_v2_fused(xs.permute(0, 2, 3, 1).contiguous(), omw, omb,
                             weight, self.bias, r,
                             train_site_edge_grad(*site))
            return _crop(y, start, h).permute(0, 3, 1, 2)
        # the reference's explicit path (training, and inference outside
        # the om-fused kernel): the om conv, rounded to the compute dtype,
        # then its bias in that dtype; offsets and the sigmoid-ed mask stay
        # in the compute dtype
        om = spatial.window(x, _CONV3, lambda t, rows: F.conv2d(
            t, omw.permute(3, 2, 0, 1), padding=(rows[0], 1)))
        om = om + omb.view(1, -1, 1, 1)
        om = om.permute(0, 2, 3, 1)
        offset = om[..., :18].contiguous()
        mask = _sigmoid(om[..., 18:], self.training).contiguous()
        r = train_site_max_dy(*site)
        xs, start = x, 0
        if sharded:
            if r is None:
                above, below = unclamped_halo(offset, site[0] - h)
            else:
                above = below = clamped_halo(r)
            xs, start = _site_rows(x, above, below)
            # the halo rows' outputs are cropped: no offset, no mask
            rows = (0, 0, 0, 0, start, xs.shape[2] - start - h)
            offset, mask = F.pad(offset, rows), F.pad(mask, rows)
        if not h:
            return _no_rows(x, self.features)
        y = dcn_v2(xs.permute(0, 2, 3, 1).contiguous(), offset, mask, weight,
                   self.bias, r, train_site_edge_grad(*site))
        return _crop(y, start, h).permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """DCN 3x3 -> BN -> ReLU.  BatchNorm takes the DCN output in the compute
    dtype, as in the reference's compiled bf16 graph under both ``xla`` and
    ``pallas_full``: there the DCN's cast of its f32 result to bf16 survives
    (unlike a conv's, ``common.conv_bn``; ``tests/test_torch_dla_site.py:
    bn_inputs``).  Under the ``conv`` ablation the DCN hands over an f32
    sum, which BatchNorm normalises in f32 and the block rounds after it,
    as the reference's bf16 BatchNorm does."""

    def __init__(self, in_features: int, features: int, dcn_impl: str = "xla",
                 dcn_max_dy: int = 0):
        super().__init__()
        self.DCN_0 = DCN(in_features, features, dcn_impl, dcn_max_dy)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.DCN_0(x)).to(x.dtype))


def bilinear_kernel(channels: int, factor: int) -> torch.Tensor:
    """Depthwise transposed-conv weight [C, 1, 2f, 2f] of the fixed
    bilinear upsample (the outer product of the 1-D kernel)."""
    w1 = torch.from_numpy(bilinear_1d(2 * factor))
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
    p = factor // 2
    win = spatial.Window(2 * factor, factor, 1, (p, p), transposed=True)
    return spatial.window(x, win, lambda t, rows: F.conv_transpose2d(
        t, weight, stride=factor, padding=(rows[0], p), groups=c))


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
        bottom = (max_pool2d(x, self.stride, self.stride)
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
        self.float32_params = tuple(f"up_{i}" for i in range(1, len(channels))
                                    if self.up_factors[i] > 1)
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
            dt = p.dtype
            f = self.up_factors[j]
            if f > 1:
                # the reference's bilinear weights are numpy f32 scalars: a
                # bf16 p is promoted, so the upsample and the sum run in
                # f32, rounded once where the node's DCN casts its input
                # (also in training: it is type promotion, not a compiler
                # choice); TF32 reads bf16 values and these weights exactly
                with tf32_convs(p):
                    p = bilinear_upsample(p.float(), f,
                                          getattr(self, f"up_{j}").float())
            layers[i] = getattr(self, f"node_{j}")((p + layers[i - 1]).to(dt))
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

