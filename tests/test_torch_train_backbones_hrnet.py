"""Training hrnet_w32, the port against the reference: one float32 train
step at 64x64, batch 2, against ``jax.value_and_grad`` (in f32 and f64)
and optax, then a checkpoint round trip (``_torch_train_step.
check_train_step``).  Its two reference steps compile for two to three
minutes on a CPU, so it is in the slow tier (``-m slow``)."""

from __future__ import annotations

import pytest

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_train_step import check_train_step


@pytest.mark.slow
def test_train_step_matches_reference(tmp_path):
    check_train_step("hrnet_w32", tmp_path)
