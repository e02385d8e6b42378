"""Training res_18, res_50, mobilenetv2 and mobilenetv3, the port against the reference: one float32 train
step at 64x64, batch 2, against ``jax.value_and_grad`` (in f32 and f64)
and optax, then a checkpoint round trip (``_torch_train_step.
check_train_step``; the 9 non-DLA families are split between
``tests/test_torch_train_backbones*.py`` to spread tier-1's time,
hrnet_w32 in the slow tier)."""

from __future__ import annotations

import pytest

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_train_step import check_train_step


@pytest.mark.parametrize("name", ["res_18", "res_50", "mobilenetv2", "mobilenetv3"])
def test_train_step_matches_reference(name, tmp_path):
    check_train_step(name, tmp_path)


if __name__ == "__main__":
    # The readings behind check_train_step's tolerances: each family's
    # step, the port's float32 one and the reference's, against the
    # reference's float64 step.  From the repository root:
    # PYTHONPATH=.:tests python tests/test_torch_train_backbones.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    from _torch_train_step import FAMILIES, port_and_reference_gaps

    for family in FAMILIES:
        port, ref = port_and_reference_gaps(family)
        print(family, "port:", {k: f"{v:.2e}" for k, v in port.items()},
              "reference f32:", {k: f"{v:.2e}" for k, v in ref.items()},
              flush=True)
