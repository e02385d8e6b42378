"""Shared model building blocks.

Counterpart of ``centerpose_tpu/models/common.py``.  Modules take NCHW
tensors (the model runs in ``channels_last`` memory format, so they are NHWC
in memory).  Submodule attribute names follow the JAX parameter tree
(``Conv_0``, ``BatchNorm_0``, ``{head}_conv``...), so that ``weights.py``
maps a snapshot key to a state-dict key by renaming its leaf only.

Compute dtype, as the reference's per-module ``dtype``: every module casts
its weights to the dtype of the activations it is given, at use.  Training
keeps float32 master parameters (``set_compute_dtype``); inference may cast
them once (``to_compute_dtype``), after which the per-use cast is free.
BatchNorm parameters and statistics stay float32 either way.  A bf16
model hands each BatchNorm its conv's f32 result, as the reference's
compiled graph does, in eval and in train mode (``conv_bn``).

BatchNorm: torch momentum 0.1 is flax momentum 0.9; eps is 1e-5.  In train
mode the port's ``BatchNorm2d`` follows flax, not torch: one pair of batch
statistics, with flax's ``E[x^2] - E[x]^2`` variance, both normalises and
updates ``running_var`` (torch would update it with the unbiased variance,
n/(n-1) larger, and normalise with its own variance formula).

Row shards (``parallel/spatial.py``): inside ``spatial.row_sharded`` each
op that reads a window of rows (``Conv2d``, ``ConvTranspose2d``, the bf16
path's ``_ConvF32``, ``max_pool2d``) runs on this shard's rows and the halo
its window reads from the neighbouring shards (``spatial.window``);
BatchNorm in eval mode, the activations and ``upsample_nearest`` are
row-local.  Outside it every op is the plain call.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from centerpose_tpu_torch.parallel import spatial
from centerpose_tpu_torch.parallel.mesh import all_reduce_sum

# Heatmap-head bias init: -log((1 - pi) / pi) with prior pi = 0.1.
HM_BIAS_INIT = -2.19


def conv_window(conv: nn.Module) -> spatial.Window:
    """The rows the ``nn.Conv2d`` or ``nn.ConvTranspose2d`` ``conv``
    reads (``spatial.window``)."""
    p = conv.padding[0]
    if isinstance(conv, nn.ConvTranspose2d):
        return spatial.Window(conv.kernel_size[0], conv.stride[0],
                              conv.dilation[0], (p, p), True,
                              conv.output_padding[0])
    return spatial.Window(conv.kernel_size[0], conv.stride[0],
                          conv.dilation[0], (p, p))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype at
    use (flax ``nn.Conv(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self.conv(x, self.weight.to(x.dtype), bias)

    def conv(self, x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None) -> torch.Tensor:
        """The conv with ``weight`` and ``bias`` as given, on row shards
        too (``spatial.window``)."""
        return spatial.window(x, conv_window(self), lambda t, rows: F.conv2d(
            t, weight, bias, self.stride, (rows[0], self.padding[1]),
            self.dilation, self.groups))


def _narrow(dtype: torch.dtype) -> bool:
    """A compute dtype narrower than float32 (bf16): the reference's
    compiled graph rounds to it where the port follows."""
    return torch.finfo(dtype).bits < 32


class _TrainBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over (N, H, W) with flax's statistics
    (``use_fast_variance``): ``mean = E[x]`` and the biased ``var =
    max(E[x^2] - E[x]^2, 0)`` in (at least) float32.  The output is
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` (torch's batch norm on
    those statistics, computed in float32 and returned in x's dtype); the
    gradient is torch's train-mode batch-norm backward on the same mean and
    ``rsqrt(var + eps)``, or flax's with its rounding where ``grad_dtype``
    is given (``_flax_grads``).  Returns ``(y, mean, var)``.

    With a process ``group`` the batch is the ranks' batches together, as
    the reference's one SPMD step sees it: the forward all-reduces ``[sum
    x, sum x^2, n]`` (one float32 tensor) and takes the statistics from
    the global sums and count N; the backward all-reduces the two channel
    sums the input gradient reads (``_sync_grads``, ``_flax_grads``).  The
    scale and bias gradients stay this rank's partial sums, which the
    data-parallel average of the gradients adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, grad_dtype, group):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = None
        if group is None:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        else:
            c = x.shape[1]
            sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                              xf.new_full((1,), xf.numel() // c)])
            all_reduce_sum(sums, group)
            count = sums[2 * c]
            mean = sums[:c] / count
            var = (sums[c:2 * c] / count - mean * mean).clamp_min(0.0)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.eps = eps
        ctx.grad_dtype = grad_dtype
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps), \
            mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        if ctx.grad_dtype is not None:
            return (*_flax_grads(gy, x, weight, mean, invstd, ctx.eps,
                                 ctx.grad_dtype, ctx.group, ctx.count),
                    None, None, None)
        if ctx.group is not None:
            return (*_sync_grads(gy, x, weight, mean, invstd, ctx.group,
                                 ctx.count), None, None, None)
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            gy, x, weight, None, None, mean, invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None, None


def _ch(t: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCHW."""
    return t.view(1, -1, 1, 1)


def _sync_grads(gy, x, weight, mean, invstd, group, count):
    """(input, scale, bias) gradients of train-mode BatchNorm over the
    ranks of ``group`` (``SyncBatchNorm``'s backward): the input gradient
    ``(gy - E[gy] - (x - mean) invstd^2 E[gy (x - mean)]) invstd scale``
    from the all-reduced ``sum gy`` and ``sum gy (x - mean)`` and the
    global count; the scale and bias gradients this rank's own sums."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    g = gy.to(xf.dtype)
    xmu = xf - _ch(mean)
    c = x.shape[1]
    sums = torch.cat([g.sum((0, 2, 3)), (g * xmu).sum((0, 2, 3))])
    gw, gb = sums[c:] * invstd, sums[:c].clone()
    all_reduce_sum(sums, group)
    mean_dy, mean_dy_xmu = sums[:c] / count, sums[c:] / count
    gx = ((g - _ch(mean_dy) - xmu * _ch(invstd * invstd * mean_dy_xmu))
          * _ch(invstd * weight))
    return gx.to(x.dtype), gw, gb


def _flax_grads(gy, x, weight, mean, invstd, eps, dtype, group=None,
                count=None):
    """(input, scale, bias) gradients of flax's train-mode BatchNorm of a
    value the reference holds in ``dtype`` (bf16), as ``jax.grad`` of it
    computes them.  Flax widens that value twice, for the statistics and
    for ``x - mean``, and the transpose of each widening rounds its part of
    the input gradient to ``dtype`` before the two parts are summed in
    ``dtype`` (the compiled train step of a bf16 ``ConvBN``).  The parts,
    in f32: ``gy * mul`` through ``x - mean`` (``mul = rsqrt(var + eps) *
    scale``); ``dmean / n + x * (dvar * 2 / n)`` through ``E[x]`` and
    ``E[x^2]``, with ``dvar = sum(gy (x - mean)) * scale * -0.5 rsqrt(var +
    eps) / (var + eps)`` and ``dmean = -sum(gy * mul) - dvar * 2 mean``.
    The input gradient is returned in x's dtype.  With a process
    ``group`` the two sums are all-reduced and n is the global ``count``;
    the scale and bias gradients stay this rank's."""
    xdt, gy, x = x.dtype, gy.float(), x.float()
    n = x.numel() // x.shape[1]
    direct = gy * _ch(invstd * weight)
    dmul = (gy * (x - _ch(mean))).sum((0, 2, 3))
    dsum = direct.sum((0, 2, 3))
    gw = dmul * invstd
    if group is not None:
        c = x.shape[1]
        sums = all_reduce_sum(torch.cat([dmul, dsum]), group)
        dmul, dsum, n = sums[:c], sums[c:], count
    dvar = dmul * weight * (-0.5 * invstd * invstd * invstd)
    dmean = -dsum - dvar * (2.0 * mean)
    stats = _ch(dmean / n) + x * _ch(dvar * (2.0 / n))
    gx = (direct.to(dtype) + stats.to(dtype)).to(xdt)
    return gx, gw, gy.sum((0, 2, 3))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode arithmetic (``flax.linen.BatchNorm``,
    ``use_fast_variance``): one pair of batch statistics, ``E[x]`` and
    ``E[x^2] - E[x]^2`` in float32 (``_TrainBatchNorm``), both normalises
    and updates the running statistics under ``no_grad`` as ``ra = m * ra +
    (1 - m) * batch`` with m = 0.9.  ``grad_dtype``: the dtype the
    reference holds ``x`` in, x's own unless given (``conv_bn`` hands over
    an f32 conv result the reference holds as bf16); where it is not
    float32 the input gradient rounds as the reference's (``_flax_grads``).
    Eval mode is ``nn.BatchNorm2d``'s.  ``process_group``: None, or the
    group whose ranks' batches train mode normalises together
    (``parallel/mesh.sync_batch_norm``); the running statistics then
    update from the global ones, equal on every rank."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.process_group = None

    def forward(self, x: torch.Tensor,
                grad_dtype: torch.dtype | None = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if grad_dtype is None and _narrow(x.dtype):
            grad_dtype = x.dtype
        y, mean, var = _TrainBatchNorm.apply(x, self.weight, self.bias,
                                             self.eps, grad_dtype,
                                             self.process_group)
        with torch.no_grad():
            m = 1.0 - self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
            self.num_batches_tracked.add_(1)
        return y


@contextlib.contextmanager
def tf32_convs(x: torch.Tensor, dtype: torch.dtype | None = None):
    """cuDNN may use TF32 in the convolutions run inside where ``x``, the
    values they read, is a bf16 tensor on a CUDA device (nothing changes
    elsewhere: a float32 model keeps the caller's setting, off in the
    tools); the caller's setting is restored on leaving.  ``dtype``: the
    dtype the convolutions read where it is not x's (an exported bf16
    program fed float32 images, whose graph records no such setting: in a
    bf16 model every f32 convolution reads bf16 values and runs here).  TF32 reads bf16
    values exactly (8 significand bits of its 11) and its products are
    exact; its tensor-core sums are f32 sums in another order and rounding
    than FFMA's, which the bf16 rows' AP feels as it feels any summation
    order.  With TF32 off the serving batch's device time doubled on an
    H100 (PERF.md, section 6)."""
    if x.device.type != "cuda" or (dtype or x.dtype) != torch.bfloat16:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _ConvF32(torch.autograd.Function):
    """The conv of a bf16 ``x`` and the weight ``w`` rounded to bf16
    (``aten.convolution``, ``transposed`` for a ``ConvTranspose2d``)
    computed in f32 on those bf16 values, with an f32 result, where the
    reference's compiled bf16 graph, eval and train step alike, keeps the
    conv's f32 result for BatchNorm (``tests/_torch_port.py:
    train_step_reading``).  Backward as that train step's: every backward
    conv reads two bf16-rounded operands, so the cotangent is rounded to
    bf16 first; the input's gradient is computed in f32 and rounded to
    bf16 (the cotangent of a bf16 value), the weight's is left in f32 (XLA
    drops that round trip on the way to the f32 parameter).  On a CUDA
    device both passes may use TF32 (``tf32_convs``), exact on bf16
    values: the backward runs after the forward's scope has exited, so it
    enters its own."""

    @staticmethod
    def forward(ctx, x, w, transposed, stride, padding, dilation,
                output_padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, transposed, output_padding,
                    groups)
        with tf32_convs(x):
            return torch.ops.aten.convolution(
                x.float(), w.to(x.dtype).float(), None, *ctx.conv)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).float()
        with tf32_convs(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x.float(), w.to(x.dtype).float(), None, *ctx.conv,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return (None if gx is None else gx.to(x.dtype),
                None if gw is None else gw.to(w.dtype),
                None, None, None, None, None, None)


def conv_bn(conv: nn.Module, bn: nn.BatchNorm2d,
            x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))`` for a bias-free ``Conv2d`` or ``ConvTranspose2d``.

    A bf16 input is computed as the reference's compiled graph computes it,
    in eval and in train mode alike: the conv's f32 result reaches
    BatchNorm unrounded.  Flax's bf16 conv returns bf16 and its BatchNorm
    promotes that to f32, but XLA drops the round trip between the two
    (the compiled HLO of every family, eval graph and train step, under
    ``dcn_impl`` xla and pallas_full alike: each ``ConvBN``'s BatchNorm
    reads an f32 convolution or dot; ``tests/_torch_port.py: bn_inputs,
    train_step_reading``).  So the conv runs in f32 on the bf16 values of
    x and of the weight (``_ConvF32``, whose backward rounds as the train
    step's), BatchNorm in f32 (its input gradient rounded as the
    reference's, ``_flax_grads``), and its output is rounded to bf16.  The DCN
    sites are not such a case: there the reference's explicit cast of the
    DCN output to the compute dtype survives compilation, and BatchNorm
    gets the rounded value (``models/dla.DeformConv``).  f32 inputs: the
    conv, then BatchNorm."""
    if not _narrow(x.dtype):
        return bn(conv(x))
    transposed = isinstance(conv, nn.ConvTranspose2d)
    y = spatial.window(x, conv_window(conv), lambda t, rows: _ConvF32.apply(
        t, conv.weight, transposed, conv.stride, (rows[0], conv.padding[1]),
        conv.dilation, conv.output_padding if transposed else (0, 0),
        conv.groups))
    return bn(y, x.dtype).to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias) -> BN -> (optional ReLU); ``groups`` and
    ``dilation`` as the reference's (padding ``dilation * (kernel - 1) //
    2``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, relu: bool = True, groups: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, kernel, stride=strides,
                             padding=dilation * (kernel - 1) // 2,
                             dilation=dilation, groups=groups, bias=False)
        nn.init.kaiming_normal_(self.Conv_0.weight)
        self.BatchNorm_0 = BatchNorm2d(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn(self.Conv_0, self.BatchNorm_0, x)
        return torch.relu(x) if self.relu else x


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight is cast to the input's dtype at
    use (flax ``nn.ConvTranspose(dtype=...)``); no bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        return spatial.window(x, conv_window(self), lambda t, rows:
                              F.conv_transpose2d(
                                  t, w, None, self.stride,
                                  (rows[0], self.padding[1]),
                                  self.output_padding, self.groups,
                                  self.dilation))


def bilinear_1d(size: int) -> np.ndarray:
    """One row of the bilinear upsampling kernel of ``size`` taps (upstream
    fill_up_weights; the 2-D kernel is its outer product)."""
    f = int(np.ceil(size / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    return np.array([1 - abs(i / f - c) for i in range(size)],
                    dtype=np.float32)


def bilinear_upsample_init(weight: torch.Tensor) -> None:
    """The reference's ``bilinear_upsample_init`` for a transposed-conv
    weight [in, out, k, k]: the bilinear kernel on the diagonal channels,
    zero elsewhere.  The kernel is symmetric, so flax's layout and the
    spatial flip of ``weights.py`` leave it as it is."""
    w1 = torch.from_numpy(bilinear_1d(weight.shape[-1]))
    with torch.no_grad():
        weight.zero_()
        for ch in range(min(weight.shape[0], weight.shape[1])):
            weight[ch, ch] = torch.outer(w1, w1)


class DeconvBN(nn.Module):
    """ConvTranspose (k4 s2, bilinear init) -> BN -> ReLU; doubles H and W.
    Flax's ``ConvTranspose(k4, s2, "SAME")`` is ``conv_transpose2d(stride
    2, padding 1)`` on the spatially flipped kernel (``weights.py``)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(in_features, features, 4,
                                               stride=2, padding=1,
                                               bias=False)
        bilinear_upsample_init(self.ConvTranspose_0.weight)
        self.BatchNorm_0 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(conv_bn(self.ConvTranspose_0, self.BatchNorm_0, x))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW tensor by a power-of-two
    factor (each value repeated ``factor`` times in H and in W; the source
    index ``dst / factor`` is exact).  Row-local: a shard's rows upsample
    to the shard's output rows (none to none)."""
    if not x.shape[2]:
        b, c, _, w = x.shape
        return x.new_zeros((b, 0, w * factor, c)).permute(0, 3, 1, 2)
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def max_pool2d(x: torch.Tensor, kernel: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding)`` (padded with -inf, as
    flax's ``max_pool``), on row shards too: there the rows past the
    image's edges are -inf and the neighbours' halo rows are exchanged."""
    win = spatial.Window(kernel, stride, 1, (padding, padding))
    return spatial.window(x, win, lambda t, rows: F.max_pool2d(
        t, kernel, stride, (rows[0], padding)), fill=float("-inf"))


class HeadStack(nn.Module):
    """Per-task heads on the stride-4 map: for each (name, channels),
    3x3 conv(head_conv) -> ReLU -> 1x1 conv(channels).  Outputs are raw
    logits in float32, NHWC (the JAX package's head layout)."""

    def __init__(self, in_features: int, heads: Dict[str, int],
                 head_conv: int = 64):
        super().__init__()
        self.heads = dict(heads)
        self.head_conv = head_conv
        for name, ch in self.heads.items():
            cin = in_features
            if head_conv > 0:
                conv = Conv2d(in_features, head_conv, 3, padding=1)
                nn.init.kaiming_normal_(conv.weight)
                nn.init.zeros_(conv.bias)
                self.add_module(f"{name}_conv", conv)
                cin = head_conv
            out = Conv2d(cin, ch, 1)
            nn.init.normal_(out.weight, std=0.001)
            nn.init.constant_(out.bias,
                              HM_BIAS_INIT if name in ("hm", "hm_hp") else 0.0)
            self.add_module(f"{name}_out", out)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name in self.heads:
            h = x
            if self.head_conv > 0:
                h = torch.relu(self._conv(f"{name}_conv", h, True))
            h = self._conv(f"{name}_out", h, False)
            out[name] = h.permute(0, 2, 3, 1).float()
        return out

    def _conv(self, name: str, x: torch.Tensor,
              round_sum: bool) -> torch.Tensor:
        """The conv ``name`` with its bias.  A bf16 input rounds where the
        reference's compiled bf16 graph rounds, in eval and in train mode:
        the conv's result to bf16, then the bias added to it, rounded again
        inside the head (``round_sum``) and left in f32 at the output, whose
        cast to f32 drops that rounding (the compiled HLO of dla_34 at
        128x128, eval graph and train step).  cuDNN would add the bias
        before a single rounding."""
        conv = getattr(self, name)
        if not _narrow(x.dtype):
            return conv(x)
        y = conv.conv(x, conv.weight.to(x.dtype), None)
        bias = conv.bias.to(x.dtype).view(1, -1, 1, 1)
        return y + bias if round_sum else y.float() + bias.float()


def add_numbered(parent: nn.Module, kind: str, child: nn.Module) -> nn.Module:
    """Register ``child`` under flax's automatic name ``{kind}_{n}``, n
    counting the children of that kind registered so far (flax numbers
    unnamed submodules per class in call order); returns ``child``."""
    n = sum(1 for k in parent._modules if k.rsplit("_", 1)[0] == kind)
    parent.add_module(f"{kind}_{n}", child)
    return child


def to_channels_last(model: nn.Module) -> nn.Module:
    """Put every ``nn.Conv2d`` and ``nn.ConvTranspose2d`` weight in
    channels_last (NHWC) memory, the layout the model's activations use.
    ``Module.to(memory_format=...)`` would also permute the DCN parameters, whose [3, 3, Cin, C] layout the
    kernel takes as it is; they are left alone."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(memory_format=torch.channels_last)
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make ``model`` compute in ``dtype`` (its ``compute_dtype``: the dtype
    its input is cast to) and leave the parameters as they are: the
    training setting, float32 master parameters cast at use."""
    model.compute_dtype = dtype
    return model


def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``set_compute_dtype`` and cast the parameters once, as the reference
    computes under ``model.compute_dtype``: conv, DCN and head weights in
    ``dtype``; BatchNorm parameters and statistics in float32 (flax
    normalises in f32 and casts the result), and every parameter a module
    lists in ``float32_params`` (the DCN bias) in float32.  The inference
    setting (the per-use casts then cost nothing)."""
    for m in model.modules():
        tensors = [*m.named_parameters(recurse=False),
                   *m.named_buffers(recurse=False)]
        keep = ({n for n, _ in tensors} if isinstance(m, nn.BatchNorm2d)
                else set(getattr(m, "float32_params", ())))
        for name, t in tensors:
            if t.is_floating_point():
                t.data = t.data.to(torch.float32 if name in keep else dtype)
    return set_compute_dtype(model, dtype)
