"""Training shufflenetv2, hardnet, darknet and efficientnet, the port against the reference: one float32 train
step at 64x64, batch 2, against ``jax.value_and_grad`` (in f32 and f64)
and optax, then a checkpoint round trip (``_torch_train_step.
check_train_step``; the 9 non-DLA families are split between
``tests/test_torch_train_backbones*.py`` to spread tier-1's time,
hrnet_w32 in the slow tier)."""

from __future__ import annotations

import pytest

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_train_step import check_train_step


@pytest.mark.parametrize("name", ["shufflenetv2", "hardnet", "darknet", "efficientnet"])
def test_train_step_matches_reference(name, tmp_path):
    check_train_step(name, tmp_path)
