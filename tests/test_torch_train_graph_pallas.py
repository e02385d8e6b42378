"""dla_34's compiled bf16 train step under ``dcn_impl: pallas_full``
(the Pallas kernels in interpret mode): it rounds where the port does, as
under xla (``tests/test_torch_train_graph.py``,
``_torch_port.check_train_reading``).  Its compile takes two to four
minutes on a CPU, so it is in the slow tier (``-m slow``)."""

import pytest

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import check_dla34_train_reading


@pytest.mark.slow
def test_reference_train_step_rounds_where_the_port_does():
    """128x128 on the snapshot: 39 of 55 BatchNorms read an f32 conv
    result, the 16 DCN sites a rounded value; every conv and dot outside
    the DCN sites reads two bf16-rounded operands, backward included; the
    heads' output bias sums stay f32."""
    check_dla34_train_reading("pallas_full")
