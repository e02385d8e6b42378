"""Model factory.

Counterpart of ``centerpose_tpu/models/factory.py``: the reference's 14
architecture names, each a module wired with the task heads.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from centerpose_tpu_torch.config import Config
from centerpose_tpu_torch.models.darknet import PoseDarknet
from centerpose_tpu_torch.models.dla import DLASeg
from centerpose_tpu_torch.models.efficientnet import PoseEfficientNet
from centerpose_tpu_torch.models.hardnet import PoseHardNet
from centerpose_tpu_torch.models.hrnet import PoseHighResolutionNet
from centerpose_tpu_torch.models.mobilenet import (PoseMobileNetV2,
                                                   PoseMobileNetV3)
from centerpose_tpu_torch.models.resnet import PoseResNet
from centerpose_tpu_torch.models.shufflenet import PoseShuffleNetV2

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.model.compute_dtype]


def _dla34(cfg: Config, heads: Dict[str, int]) -> nn.Module:
    return DLASeg(heads=heads, head_conv=cfg.model.head_conv,
                  dcn_impl=cfg.model.dcn_impl,
                  dcn_max_dy=cfg.model.dcn_max_dy,
                  dcn_fused_om=cfg.model.dcn_fused_om)


def _with_heads(build: Callable[..., nn.Module], *args) -> Callable:
    """A backbone built from ``args``, the heads and ``head_conv``."""
    return lambda cfg, heads: build(*args, heads, cfg.model.head_conv)


MODEL_FACTORY: Dict[str, Callable[[Config, Dict[str, int]], nn.Module]] = {
    **{f"res_{n}": _with_heads(PoseResNet, n) for n in (18, 34, 50, 101, 152)},
    "dla_34": _dla34,
    "hrnet_w32": _with_heads(PoseHighResolutionNet, 32),
    "hrnet_w48": _with_heads(PoseHighResolutionNet, 48),
    "mobilenetv2": _with_heads(PoseMobileNetV2),
    "mobilenetv3": _with_heads(PoseMobileNetV3),
    "shufflenetv2": _with_heads(PoseShuffleNetV2),
    "hardnet": _with_heads(PoseHardNet),
    "darknet": _with_heads(PoseDarknet),
    "efficientnet": _with_heads(PoseEfficientNet),
}


def create_model(cfg: Config) -> nn.Module:
    """A float32 CPU module wired with the task heads; callers move it with
    ``.to(device, dtype)`` (see ``Detector``)."""
    name = cfg.model.name
    if name not in MODEL_FACTORY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(MODEL_FACTORY)}")
    return MODEL_FACTORY[name](cfg, cfg.model.heads())
