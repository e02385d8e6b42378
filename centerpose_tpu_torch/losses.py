"""Losses.  So far only the clamped sigmoid that inference uses
(counterpart of ``centerpose_tpu/losses.py: sigmoid_clamped``)."""

from __future__ import annotations

import torch


def sigmoid_clamped(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid in float32, clamped to [eps, 1 - eps]."""
    return torch.sigmoid(x).float().clamp(eps, 1.0 - eps)
