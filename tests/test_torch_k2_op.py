"""K2 as the ``torch.library`` operator ``centerpose::dcn_v2``
(``centerpose_tpu_torch/ops/dcn_cuda.py``): schema, fake kernel, autograd,
FLOP formula; and the serving function's ``torch.export`` graph wherever a
DCN site runs K2 (dla_34 at 64x64: one node per call under ``pallas_full``,
with ``dcn_fused_om`` off and under ``xla``), each round trip bit-equal to
eager ``Detector.process``, on the CPU."""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import dcn_v2 as dcn_v2_plain
from centerpose_tpu_torch.tools import export as export_cli
from centerpose_tpu_torch.weights import state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ

RES = 64
K1 = torch.ops.centerpose.dcn_v2_fused.default
K2 = torch.ops.centerpose.dcn_v2.default


def _k2_args(seed: int, cin: int = 4, cout: int = 6, hw: int = 8):
    """x, offset (|dy| past 6 at some taps), sigmoid-ed mask, weight,
    bias."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(2, hw, hw, cin))
    offset = r.normal(size=(2, hw, hw, 18)) * 4.0
    mask = 1.0 / (1.0 + np.exp(-r.normal(size=(2, hw, hw, 9))))
    w = r.normal(size=(3, 3, cin, cout))
    bias = r.normal(size=(cout,))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, offset, mask, w, bias)]


@pytest.mark.parametrize("max_dy,bias", [(6.0, True), (None, False)])
def test_k2_op_passes_opcheck(max_dy, bias):
    """Schema, fake kernel, autograd registration and its traced
    backward, on the CPU implementation."""
    x, off, mask, w, b = _k2_args(0)
    args = [t.requires_grad_() for t in (x, off, mask, w)]
    args += [b.requires_grad_() if bias else None, max_dy, 1.0]
    result = torch.library.opcheck(K2, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_k2_op_cpu_is_the_plain_version_and_counts_flops():
    from torch.utils.flop_counter import FlopCounterMode

    x, off, mask, w, b = _k2_args(1)
    dc.reset_launch_counts()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        y = K2(x, off, mask, w, b, 6.0, 1.0)
        got = dc.dcn_v2(x, off, mask, w, b, 6)
    assert torch.equal(y, dcn_v2_plain(x, off, mask, w, b, 6))
    assert torch.equal(got, y) and dc.dcn_v2.launches == 0
    assert y.shape == (2, 8, 8, 6) and y.dtype == torch.float32
    # the wrapper's call and the direct one: 2 B H W 9 Cin Cout each
    assert counter.get_total_flops() == 2 * (2 * 2 * 64 * 9 * 4 * 6)


@pytest.mark.parametrize("edge_grad", [1.0, 0.5])
def test_k2_op_gradient_matches_plain_autograd(edge_grad):
    """The operator's registered backward on the CPU (the backward
    kernel's plain version) against autograd of the plain version (the
    wrapper keeps the latter with gradients on), the clamp's edge
    gradient included: some taps sit at exactly |dy| = 6."""
    args = _k2_args(2)
    args[1][0, :2, :2, 0::2] = 6.0
    ct = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 8, 8, 6)).astype(np.float32))
    grads = []
    for fn in (lambda *a: K2(*a, 6.0, edge_grad),
               lambda *a: dcn_v2_plain(*a, 6.0, edge_grad)):
        leaves = [t.clone().requires_grad_() for t in args]
        fn(*leaves).backward(ct)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _cfg(dcn_impl: str, fused_om: bool):
    return update_config(default_config(), {"model": {
        "name": "dla_34", "input_res": RES, "output_res": RES // 4,
        "head_conv": 256, "dcn_impl": dcn_impl, "dcn_fused_om": fused_om,
        "compute_dtype": "bfloat16"}})


@pytest.mark.parametrize("dcn_impl,fused_om,want", [
    ("pallas_full", True, (5, 11)),
    ("pallas_full", False, (0, 16)),
    ("xla", True, (0, 16))])
def test_dla34_graph_holds_k1_and_k2_at_each_call(tmp_path, dcn_impl,
                                                  fused_om, want):
    """dla_34 bf16 at 64x64: under ``pallas_full`` the 5 calls of the
    64->64 site at stride 4 take K1 (``site_om_fused``) and the other 11
    K2; with ``dcn_fused_om`` off, and under ``xla``, all 16 take K2.  One
    operator node per call, in eager's order, and the reloaded program's
    rows bit-equal to eager's."""
    det = Detector(_cfg(dcn_impl, fused_om), state_dict_from_npz(NPZ),
                   device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, RES, RES, 3)).astype(np.float32))
    calls = []
    real = {"fused": dc.dcn_v2_fused_op, "k2": dc.dcn_v2_op}

    def spy(kind):
        def call(*a):
            calls.append(kind)
            return real[kind](*a)
        return call

    with mock.patch.object(dc, "dcn_v2_fused_op", spy("fused")), \
            mock.patch.object(dc, "dcn_v2_op", spy("k2")):
        eager = det.process(x)
    assert (calls.count("fused"), calls.count("k2")) == want
    program = export_cli.export_serving(det, x)
    path = str(Path(tmp_path) / "dla.pt2")
    export_cli.save_serving(program, det, path)
    served = export_cli.load_serving(path)
    for graph in (program.graph, served.program.graph):
        nodes = ["fused" if n.target is K1 else "k2" for n in graph.nodes
                 if n.target in (K1, K2)]
        assert nodes == calls
    assert torch.equal(served(x), eager)
