"""hrnet_w32's compiled bf16 train step at 64x64: it rounds where the
port does, as the other families' (``tests/test_torch_train_graph_
backbones.py``), with the BatchNorms of its last fuse into branches 1-3
live.  Its compile takes about four minutes on a CPU (XLA's passes over
~300 bf16 ``ConvBN``s and their backward), so it is in the slow tier
(``-m slow``)."""

import pytest

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import check_family_reading


@pytest.mark.slow
def test_reference_train_step_rounds_where_the_port_does(tmp_path):
    check_family_reading("hrnet_w32", tmp_path)
