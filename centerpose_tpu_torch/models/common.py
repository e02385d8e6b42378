"""Shared model building blocks.

Counterpart of ``centerpose_tpu/models/common.py``.  Modules take NCHW
tensors (the model runs in ``channels_last`` memory format, so they are NHWC
in memory).  Submodule attribute names follow the JAX parameter tree
(``Conv_0``, ``BatchNorm_0``, ``{head}_conv``...), so that ``weights.py``
maps a snapshot key to a state-dict key by renaming its leaf only.
BatchNorm: torch momentum 0.1 is flax momentum 0.9; eps is 1e-5.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

# Heatmap-head bias init: -log((1 - pi) / pi) with prior pi = 0.1.
HM_BIAS_INIT = -2.19


class ConvBN(nn.Module):
    """Conv (no bias) -> BN -> (optional ReLU)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, relu: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride=strides,
                                padding=(kernel - 1) // 2, bias=False)
        nn.init.kaiming_normal_(self.Conv_0.weight)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
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
                conv = nn.Conv2d(in_features, head_conv, 3, padding=1)
                nn.init.kaiming_normal_(conv.weight)
                nn.init.zeros_(conv.bias)
                self.add_module(f"{name}_conv", conv)
                cin = head_conv
            out = nn.Conv2d(cin, ch, 1)
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


def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model`` to compute in ``dtype`` as the reference does under
    ``model.compute_dtype``: conv, DCN and head weights in ``dtype``;
    BatchNorm parameters and statistics in float32 (flax normalises in f32
    and casts the result), and every parameter a module lists in
    ``float32_params`` (the DCN bias) in float32."""
    for m in model.modules():
        tensors = [*m.named_parameters(recurse=False),
                   *m.named_buffers(recurse=False)]
        keep = ({n for n, _ in tensors} if isinstance(m, nn.BatchNorm2d)
                else set(getattr(m, "float32_params", ())))
        for name, t in tensors:
            if t.is_floating_point():
                t.data = t.data.to(torch.float32 if name in keep else dtype)
    return model
