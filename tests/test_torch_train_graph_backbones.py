"""Where the reference's compiled bf16 train step of every other
backbone rounds (``_torch_port.train_step_reading``: the forward in train
mode and ``jax.grad`` of the loss at 64x64, on seeded weights): the
premise of the port's train-mode ``conv_bn`` and heads holds in each
family, as ``tests/test_torch_train_graph.py`` reads it for dla_34."""

from __future__ import annotations

import pytest

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import check_family_reading

# the non-DLA families but hrnet_w32, whose compile takes minutes
# (tests/test_torch_train_graph_hrnet.py)
FAMILIES = ["res_18", "res_50", "mobilenetv2", "mobilenetv3",
            "shufflenetv2", "hardnet", "darknet", "efficientnet"]


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_train_step_rounds_where_the_port_does(name, tmp_path):
    """Every BatchNorm of the port is one of the compiled step's, each
    reads an unrounded f32 conv result, every conv and dot, forward and
    backward, reads two bf16-rounded operands, and the heads' output bias
    sums stay f32 (``check_train_reading``).  Unlike the eval graph
    (``test_torch_backbones.py: DEAD_BN``), the train step keeps the
    BatchNorms no head reads: their statistics are outputs."""
    check_family_reading(name, tmp_path)
