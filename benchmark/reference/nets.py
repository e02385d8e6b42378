"""Plain float32 reference of the benchmark's two networks, DLA-34 with
DCNv2 aggregation and HRNet-W32, each with the six CenterNet pose heads.

Written from the published architectures in plain PyTorch: NCHW
``torch.nn.functional`` calls, a modulated deformable convolution as a
bilinear gather and one matrix product, no hand-written kernel, no cache
and no batching trick.  It imports nothing of the program under test.

Weights come straight from a snapshot ``.npz`` in the flax layout (one
array per leaf, keyed ``params:['a']['b']['kernel']`` or
``batch_stats:['a']['b']['mean']``); ``Params`` turns each into a float32
tensor in the layout a ``torch.nn.functional`` call takes.

``Numerics`` says how the products are computed: exactly in float32
(``"f32"``), or with every operand of a convolution or DCN product first
rounded to float8 e4m3 under a per-tensor scale (``"fp8"``), the control
that one precision step below bfloat16 gives.  The TF32 control of a
float32 configuration is the same float32 reference run with cuDNN's and
cuBLAS's TF32 switched on (``tf32``).

Departures from the published networks, each the deployed system's:
every DCN site clips the y component of its offsets to the radius the
configuration file gives for its shape (``dcn_r``; null: unclipped), as
the deployed policy does; BatchNorm's epsilon is 1e-5.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_PATH = re.compile(r"\['([^']+)'\]")
BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Params:
    """The snapshot's arrays as float32 tensors on ``device``, looked up by
    path: ``p.conv("base", "level0", "Conv_0")`` is the OIHW weight of the
    kernel at that path.  ``trainable``: the ``params`` leaves require a
    gradient (the training reference).  ``dtype``: float32, or float64
    for a reading of float32's own rounding."""

    def __init__(self, path: str, device, trainable: bool = False,
                 dtype=torch.float32):
        self.t: Dict[Tuple[str, ...], torch.Tensor] = {}
        self.keys: Dict[Tuple[str, ...], str] = {}
        with np.load(path) as data:
            for key in data.files:
                group, _, rest = key.partition(":")
                parts = (group, *_PATH.findall(rest))
                arr = np.asarray(data[key], dtype=np.float32)
                t = torch.from_numpy(arr).to(device, dtype)
                if trainable and group == "params":
                    t.requires_grad_(True)
                self.t[parts] = t
                self.keys[parts] = key

    def get(self, *path: str) -> torch.Tensor:
        return self.t[("params", *path)]

    def has(self, *path: str) -> bool:
        return ("params", *path) in self.t

    def stat(self, *path: str) -> torch.Tensor:
        return self.t[("batch_stats", *path)]

    def conv(self, *path: str) -> torch.Tensor:
        """An HWIO conv kernel at ``path`` as OIHW."""
        return self.get(*path, "kernel").permute(3, 2, 0, 1)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every ``params`` leaf by its snapshot key."""
        return {self.keys[k]: v for k, v in self.t.items()
                if k[0] == "params"}


class Numerics:
    """How the reference computes its products.  ``mode``: ``"f32"``,
    ``"fp8"`` (operands rounded to float8 e4m3 under a per-tensor scale
    before each product, the products summed in float32; the gradient
    passes the rounding unchanged) or ``"fp8a"`` (the products' results
    rounded so too, as activations stored in float8).  ``train``:
    BatchNorm normalises with the batch's statistics (biased variance) and
    the running statistics are not read."""

    def __init__(self, mode: str = "f32", train: bool = False):
        if mode not in ("f32", "fp8", "fp8a"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode
        self.train = train

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """A product's result as it is stored: rounded to float8 too under
        ``"fp8a"``, as it is under every other mode."""
        return self.q(t) if self.mode == "fp8a" else t

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return t
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        r = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
        # the rounded value forward; the gradient passes as through the
        # identity, and the products' backward reads the rounded operands
        return t + (r - t.detach())


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's and cuBLAS's TF32 switched ``on`` inside, restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def conv(nx: Numerics, x, w, b=None, stride=1, padding=0, groups=1):
    return nx.out(F.conv2d(nx.q(x), nx.q(w), b, stride, padding, 1, groups))


def batch_norm(nx: Numerics, p: Params, path, x):
    scale, bias = p.get(*path, "scale"), p.get(*path, "bias")
    if nx.train:
        mean = x.mean((0, 2, 3))
        var = (x * x).mean((0, 2, 3)) - mean * mean
    else:
        mean, var = p.stat(*path, "mean"), p.stat(*path, "var")
    inv = torch.rsqrt(var.clamp_min(0.0) + BN_EPS) * scale
    return (x - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) \
        + bias.view(1, -1, 1, 1)


def conv_bn(nx, p, path, x, stride=1, relu=True):
    """``ConvBN`` at ``path``: conv (padding ``(k - 1) // 2``, no bias),
    BatchNorm, optional ReLU."""
    w = p.conv(*path, "Conv_0")
    y = conv(nx, x, w, None, stride, (w.shape[-1] - 1) // 2)
    y = batch_norm(nx, p, (*path, "BatchNorm_0"), y)
    return torch.relu(y) if relu else y


_KY = torch.tensor([-1., -1., -1., 0., 0., 0., 1., 1., 1.])
_KX = torch.tensor([-1., 0., 1., -1., 0., 1., -1., 0., 1.])


def dcn(nx: Numerics, x, offset, mask, w, b, r: Optional[float]):
    """Modulated deformable 3x3 conv (stride 1, padding 1, one group) of the
    NCHW ``x`` [B, C, H, W]: ``offset`` [B, 18, H, W] holds (dy, dx) per tap
    in row-major tap order, ``mask`` [B, 9, H, W] the modulation; tap k of
    output (i, j) samples x bilinearly at (i + ky + dy, j + kx + dx), zero
    outside the image.  ``r``: dy clipped to [-r, r] first (None: not
    clipped).  ``w``: [3, 3, Cin, Cout] (tap-major), ``b``: [Cout]."""
    bsz, c, h, wd = x.shape
    dev = x.device
    off = offset.reshape(bsz, 9, 2, h, wd)
    dy, dx = off[:, :, 0], off[:, :, 1]
    if r is not None:
        dy = dy.clamp(-r, r)
    sy = torch.arange(h, device=dev, dtype=x.dtype).view(1, 1, h, 1) \
        + _KY.to(dev).view(1, 9, 1, 1) + dy
    sx = torch.arange(wd, device=dev, dtype=x.dtype).view(1, 1, 1, wd) \
        + _KX.to(dev).view(1, 9, 1, 1) + dx
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    flat = x.reshape(bsz, c, h * wd)
    cols = 0
    for cy, cx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + cy, x0 + cx
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= wd - 1)
        idx = (yy.clamp(0, h - 1) * wd + xx.clamp(0, wd - 1)).long()
        g = torch.gather(flat, 2, idx.reshape(bsz, 1, 9 * h * wd)
                         .expand(bsz, c, 9 * h * wd))
        cols = cols + g.reshape(bsz, c, 9, h, wd) \
            * (wt * ok * mask).unsqueeze(1)
    # [B, C, 9, H, W] -> [B, H, W, 9, C] rows against w as [9 * C, Cout]
    cols = cols.permute(0, 3, 4, 2, 1).reshape(bsz * h * wd, 9 * c)
    y = nx.out(nx.q(cols) @ nx.q(w.reshape(9 * c, -1)) + b)
    return y.reshape(bsz, h, wd, -1).permute(0, 3, 1, 2)


def deform_conv(nx, p, path, x, dcn_r: Dict[str, Optional[float]]):
    """``DeformConv`` at ``path``: the offset/mask 3x3 conv, DCNv2 clipped
    at the radius of the site's shape, BatchNorm, ReLU."""
    site = (*path, "DCN_0")
    omw = p.get(*site, "conv_offset_mask", "kernel").permute(3, 2, 0, 1)
    om = conv(nx, x, omw, p.get(*site, "conv_offset_mask", "bias"), 1, 1)
    w = p.get(*site, "kernel")
    key = site_key(x.shape[2], x.shape[3], w.shape[2], w.shape[3])
    args = (nx, x, om[:, :18], torch.sigmoid(om[:, 18:27]), w,
            p.get(*site, "bias"), dcn_r[key])
    if torch.is_grad_enabled():
        # the gathered columns are recomputed in the backward, not kept:
        # at batch 32 they would outgrow the card
        y = checkpoint(dcn, *args, use_reentrant=False)
    else:
        y = dcn(*args)
    return torch.relu(batch_norm(nx, p, (*path, "BatchNorm_0"), y))


def site_key(h: int, w: int, cin: int, cout: int) -> str:
    """A DCN site's key in a configuration's ``dcn_r`` table."""
    return f"{h}x{w}:{cin}->{cout}"


def bilinear_up(x, f: int):
    """The frozen bilinear upsample by ``f``: a depthwise transposed conv
    (kernel 2f, stride f, padding f // 2) with upstream's fill_up_weights."""
    k = 2 * f
    fc = int(np.ceil(k / 2.0))
    c0 = (2 * fc - 1 - fc % 2) / (2.0 * fc)
    w1 = torch.tensor([1 - abs(i / fc - c0) for i in range(k)],
                      dtype=x.dtype, device=x.device)
    c = x.shape[1]
    w = torch.outer(w1, w1).expand(c, 1, k, k).contiguous()
    return F.conv_transpose2d(x, w, stride=f, padding=f // 2, groups=c)


def heads(nx, p, x, names: Dict[str, int]):
    """The heads on the stride-4 map: per head, 3x3 conv + bias, ReLU, 1x1
    conv + bias; NHWC float32 maps."""
    out = {}
    for name in names:
        pre = ("HeadStack_0", f"{name}_conv")
        h = torch.relu(conv(nx, x, p.conv(*pre), p.get(*pre, "bias"), 1, 1))
        pre = ("HeadStack_0", f"{name}_out")
        h = conv(nx, h, p.conv(*pre), p.get(*pre, "bias"))
        out[name] = h.permute(0, 2, 3, 1)
    return out


# --------------------------------------------------------------------------
# DLA-34 (levels 1,1,1,2,2,1; channels 16..512) with DLAUp/IDAUp of DCNv2
# --------------------------------------------------------------------------

DLA_CH = (16, 32, 64, 128, 256, 512)
DLA_LEVELS = (1, 1, 1, 2, 2, 1)


def _basic(nx, p, path, x, stride, residual):
    y = conv_bn(nx, p, (*path, "ConvBN_0"), x, stride)
    y = conv_bn(nx, p, (*path, "ConvBN_1"), y, 1, relu=False)
    return torch.relu(y + residual)


def _tree(nx, p, path, x, levels, stride, level_root, residual=None,
          children=None):
    children = [] if children is None else list(children)
    bottom = F.max_pool2d(x, stride, stride) if stride > 1 else x
    if p.has(*path, "project", "Conv_0", "kernel") and residual is None:
        residual = conv_bn(nx, p, (*path, "project"), bottom, relu=False)
    if residual is None:
        residual = bottom
    if level_root:
        children.append(bottom)
    if levels == 1:
        x1 = _basic(nx, p, (*path, "tree1"), x, stride, residual)
        x2 = _basic(nx, p, (*path, "tree2"), x1, 1, x1)
        cat = torch.cat([x2, x1] + children, 1)
        return torch.relu(conv_bn(nx, p, (*path, "root", "ConvBN_0"), cat,
                                  relu=False))
    x1 = _tree(nx, p, (*path, "tree1"), x, levels - 1, stride, False,
               residual)
    children.append(x1)
    return _tree(nx, p, (*path, "tree2"), x1, levels - 1, 1, False, None,
                 children)


def _ida(nx, p, path, layers, startp, endp, dcn_r):
    layers = list(layers)
    for i in range(startp + 1, endp):
        j = i - startp
        y = deform_conv(nx, p, (*path, f"proj_{j}"), layers[i], dcn_r)
        f = layers[i - 1].shape[2] // y.shape[2]
        if f > 1:
            y = bilinear_up(y, f)
        layers[i] = deform_conv(nx, p, (*path, f"node_{j}"),
                                y + layers[i - 1], dcn_r)
    return layers


def dla34(nx: Numerics, p: Params, x, head_names: Dict[str, int],
          dcn_r: Dict[str, Optional[float]]):
    """NCHW normalised images -> NHWC head maps (stride 4)."""
    x = conv_bn(nx, p, ("base", "base_layer"), x)
    x = conv_bn(nx, p, ("base", "level0"), x)
    feats = [x]
    x = conv_bn(nx, p, ("base", "level1"), x, 2)
    feats.append(x)
    for lvl in (2, 3, 4, 5):
        x = _tree(nx, p, ("base", f"level{lvl}"), x, DLA_LEVELS[lvl], 2,
                  lvl > 2)
        feats.append(x)
    # DLAUp from level 2: ida_0 fuses levels 4-5, ida_1 3-5, ida_2 2-5
    layers = feats[2:]
    outs = [layers[-1]]
    for i in range(len(layers) - 1):
        j = -i - 2
        layers = _ida(nx, p, ("dla_up", f"ida_{i}"), layers,
                      len(layers) + j, len(layers), dcn_r)
        outs.insert(0, layers[-1])
    y = _ida(nx, p, ("ida_up",), outs[:3], 0, 3, dcn_r)
    return heads(nx, p, y[-1], head_names)


# --------------------------------------------------------------------------
# HRNet-W32 (stage modules 1, 4, 3; four bottlenecks in stage 1)
# --------------------------------------------------------------------------

def _block(nx, p, path, x):
    y = conv_bn(nx, p, (*path, "ConvBN_0"), x)
    y = conv_bn(nx, p, (*path, "ConvBN_1"), y, relu=False)
    return torch.relu(y + x)


def _bottleneck(nx, p, path, x):
    y = conv_bn(nx, p, (*path, "ConvBN_0"), x)
    y = conv_bn(nx, p, (*path, "ConvBN_1"), y)
    y = conv_bn(nx, p, (*path, "ConvBN_2"), y, relu=False)
    res = x
    if p.has(*path, "ConvBN_3", "Conv_0", "kernel"):
        res = conv_bn(nx, p, (*path, "ConvBN_3"), x, relu=False)
    return torch.relu(y + res)


def _hr_module(nx, p, path, xs):
    n = len(xs)
    ys = []
    for i, x in enumerate(xs):
        for b in range(4):
            x = _block(nx, p, (*path, f"branch{i}_block{b}"), x)
        ys.append(x)
    outs = []
    for i in range(n):
        acc = 0
        for j in range(n):
            if j == i:
                t = ys[j]
            elif j > i:
                t = conv_bn(nx, p, (*path, f"fuse_{i}_{j}"), ys[j],
                            relu=False)
                t = F.interpolate(t, scale_factor=2 ** (j - i),
                                  mode="nearest")
            else:
                t = ys[j]
                for s in range(i - j):
                    t = conv_bn(nx, p, (*path, f"fuse_{i}_{j}_{s}"), t, 2,
                                relu=s != i - j - 1)
            acc = acc + t
        outs.append(torch.relu(acc))
    return outs


def hrnet_w32(nx: Numerics, p: Params, x, head_names: Dict[str, int],
              modules=(1, 4, 3)):
    """NCHW normalised images -> NHWC head maps (stride 4)."""
    x = conv_bn(nx, p, ("stem1",), x, 2)
    x = conv_bn(nx, p, ("stem2",), x, 2)
    for b in range(4):
        x = _bottleneck(nx, p, (f"layer1_{b}",), x)
    xs = [conv_bn(nx, p, ("trans1_0",), x), conv_bn(nx, p, ("trans1_1",), x,
                                                     2)]
    for stage, count in zip((2, 3, 4), modules):
        if stage > 2:
            xs = xs + [conv_bn(nx, p, (f"trans{stage - 1}_{stage - 1}",),
                               xs[-1], 2)]
        for m in range(count):
            xs = _hr_module(nx, p, (f"stage{stage}_m{m}",), xs)
    return heads(nx, p, xs[0], head_names)


NETWORKS = {"dla_34": dla34, "hrnet_w32": hrnet_w32}


def forward(arch: str, nx: Numerics, p: Params, x_nhwc: torch.Tensor,
            head_names: Dict[str, int],
            dcn_r: Optional[Dict[str, Optional[float]]] = None):
    """The network ``arch`` on NHWC normalised float32 images."""
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    if arch == "dla_34":
        return dla34(nx, p, x, head_names, dcn_r or {})
    return NETWORKS[arch](nx, p, x, head_names)
