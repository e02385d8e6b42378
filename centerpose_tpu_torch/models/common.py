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
BatchNorm parameters and statistics stay float32 either way.

BatchNorm: torch momentum 0.1 is flax momentum 0.9; eps is 1e-5.  In train
mode the port's ``BatchNorm2d`` follows flax, not torch: one pair of batch
statistics, with flax's ``E[x^2] - E[x]^2`` variance, both normalises and
updates ``running_var`` (torch would update it with the unbiased variance,
n/(n-1) larger, and normalise with its own variance formula).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

# Heatmap-head bias init: -log((1 - pi) / pi) with prior pi = 0.1.
HM_BIAS_INIT = -2.19


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype at
    use (flax ``nn.Conv(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class _TrainBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over (N, H, W) with flax's statistics
    (``use_fast_variance``): ``mean = E[x]`` and the biased ``var =
    max(E[x^2] - E[x]^2, 0)`` in (at least) float32.  The output is
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` (torch's batch norm on
    those statistics, computed in float32 and returned in x's dtype); the
    gradient is torch's train-mode batch-norm backward on the same mean and
    ``rsqrt(var + eps)``.  Returns ``(y, mean, var)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps), \
            mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            gy, x, weight, None, None, mean, invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's train-mode arithmetic (``flax.linen.BatchNorm``,
    ``use_fast_variance``): one pair of batch statistics, ``E[x]`` and
    ``E[x^2] - E[x]^2`` in float32 (``_TrainBatchNorm``), both normalises
    and updates the running statistics under ``no_grad`` as ``ra = m * ra +
    (1 - m) * batch`` with m = 0.9.  Eval mode is ``nn.BatchNorm2d``'s."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, var = _TrainBatchNorm.apply(x, self.weight, self.bias,
                                             self.eps)
        with torch.no_grad():
            m = 1.0 - self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
            self.num_batches_tracked.add_(1)
        return y


class ConvBN(nn.Module):
    """Conv (no bias) -> BN -> (optional ReLU)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, relu: bool = True):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, kernel, stride=strides,
                             padding=(kernel - 1) // 2, bias=False)
        nn.init.kaiming_normal_(self.Conv_0.weight)
        self.BatchNorm_0 = BatchNorm2d(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.relu else x


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
                h = torch.relu(getattr(self, f"{name}_conv")(h))
            h = getattr(self, f"{name}_out")(h)
            out[name] = h.permute(0, 2, 3, 1).float()
        return out


def to_channels_last(model: nn.Module) -> nn.Module:
    """Put every ``nn.Conv2d`` weight in channels_last (NHWC) memory, the
    layout the model's activations use.  ``Module.to(memory_format=...)``
    would also permute the DCN parameters, whose [3, 3, Cin, C] layout the
    kernel takes as it is; they are left alone."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
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
