"""Deployment export (``centerpose_tpu_torch/tools/export.py``): K1 as the
``torch.library`` operator ``centerpose::dcn_v2_fused`` (schema, fake
kernel, autograd, FLOP formula), the serving function's ``torch.export``
round trip bit-equal to eager ``Detector.process`` and against the
reference's ``_process_raw``, and the CLI, on the CPU at 64x64."""

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.common import tf32_convs
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain
from centerpose_tpu_torch.tools import export as export_cli
from centerpose_tpu_torch.weights import state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ, FakeCudaTensor, jax_variables

ROOT = Path(__file__).resolve().parent.parent
RES18 = str(ROOT / "output" / "res18_hard_artifact" / "params_f16.npz")
RES = 64
OP = torch.ops.centerpose.dcn_v2_fused.default


def _cfg(name: str = "res_18", **test):
    ov = {"model": {"name": name, "input_res": RES, "output_res": RES // 4}}
    if name == "dla_34":
        ov["model"].update(head_conv=256, dcn_impl="pallas_full")
    if test:
        ov["test"] = test
    return update_config(default_config(), ov)


def _images(n: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, RES, RES, 3)).astype(np.float32))


def _k1_args(seed: int, cin: int = 4, cout: int = 6, hw: int = 8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, hw, hw, cin, generator=g)
    omw = torch.randn(3, 3, cin, 27, generator=g) * 2.0
    omb = torch.randn(27, generator=g)
    w = torch.randn(3, 3, cin, cout, generator=g)
    bias = torch.randn(cout, generator=g)
    return x, omw, omb, w, bias


def _round_trip(det: Detector, x: torch.Tensor, path: Path):
    program = export_cli.export_serving(det, x)
    export_cli.save_serving(program, det, str(path))
    return program, export_cli.load_serving(str(path))


@pytest.mark.parametrize("max_dy,bias", [(6.0, True), (None, False)])
def test_k1_op_passes_opcheck(max_dy, bias):
    """Schema, fake kernel, autograd registration and its traced
    backward, on the CPU implementation."""
    x, omw, omb, w, b = _k1_args(0)
    args = [t.requires_grad_() for t in (x, omw, omb, w)]
    args += [b.requires_grad_() if bias else None, max_dy, 1.0]
    result = torch.library.opcheck(OP, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_k1_op_cpu_is_the_plain_version_and_counts_flops():
    from torch.utils.flop_counter import FlopCounterMode

    x, omw, omb, w, b = _k1_args(1)
    dc.reset_launch_counts()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        y, om = OP(x, omw, omb, w, b, 6.0, 1.0)
        got = dc.dcn_v2_fused(x, omw, omb, w, b, 6)
    assert torch.equal(y, dcn_v2_fused_plain(x, omw, omb, w, b, 6))
    assert torch.equal(got, y) and dc.dcn_v2_fused.launches == 0
    assert om.shape == (2, 8, 8, 27) and om.dtype == torch.float32
    # the wrapper's call and the direct one: 2 B H W 9 Cin (Cout + 27) each
    assert counter.get_total_flops() == 2 * (2 * 2 * 64 * 9 * 4 * (6 + 27))


def test_k1_op_gradient_matches_plain_autograd():
    """The operator's registered backward on the CPU against autograd of
    the plain version (the wrapper keeps the latter with gradients on)."""
    args = _k1_args(2)
    ct = torch.randn(2, 8, 8, 6, generator=torch.Generator().manual_seed(3))
    grads = []
    for fn in (lambda *a: OP(*a, 6.0, 0.5)[0],
               lambda *a: dcn_v2_fused_plain(*a, 6.0, 0.5)):
        leaves = [t.clone().requires_grad_() for t in args]
        fn(*leaves).backward(ct)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_loader_runs_a_bf16_program_with_tf32_convs():
    """A traced graph records no TF32 setting: the loader's scope turns it
    on for a bf16 program on the card, as eager serving's convs run, and
    leaves a float32 program (and the CPU) under the caller's."""
    x = FakeCudaTensor(torch.zeros(1, 4, 4, 3))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        seen = []
        for t, dtype in ((x, torch.bfloat16), (x, torch.float32),
                         (torch.zeros(1), torch.bfloat16)):
            with tf32_convs(t, dtype):
                seen.append(torch.backends.cudnn.allow_tf32)
            assert torch.backends.cudnn.allow_tf32 is False
        assert seen == [True, False, False]
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("dtype,flip", [("float32", False),
                                        ("float32", True),
                                        ("bfloat16", False)])
def test_round_trip_bit_equal_to_eager(tmp_path, dtype, flip):
    cfg = update_config(_cfg(flip_test=flip),
                        {"model": {"compute_dtype": dtype}})
    det = Detector(cfg, state_dict_from_npz(RES18), device="cpu")
    x = export_cli.example_input(cfg, 2, "cpu")
    x.copy_(_images(x.shape[0]))
    _, served = _round_trip(det, x, tmp_path / "r18.pt2")
    assert served.dtype == getattr(torch, dtype)
    got = served(x)
    want = det.process(x)
    # the reference's rule: the input doubles under flip, and so the rows
    assert got.shape == (4 if flip else 2, 100, 40)
    assert torch.equal(got, want)


def test_round_trip_matches_reference_process_raw(tmp_path):
    import jax
    from centerpose_tpu.config import default_config as j_default
    from centerpose_tpu.config import update_config as j_update
    from centerpose_tpu.inference.detector import Detector as JaxDetector

    ov = {"model": {"name": "res_18", "input_res": RES,
                    "output_res": RES // 4}}
    jd = JaxDetector(j_update(j_default(), ov),
                     variables=jax_variables(RES18))
    x = _images(2, seed=5)
    want = np.asarray(jax.jit(jd._process_raw)(jd.variables, x.numpy()))
    det = Detector(_cfg(), state_dict_from_npz(RES18), device="cpu")
    _, served = _round_trip(det, x, tmp_path / "r18.pt2")
    got = served(x).numpy()
    assert got.shape == want.shape == (2, 100, 40)
    np.testing.assert_allclose(got[:, :, 4], want[:, :, 4], atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_dla34_graph_holds_k1_at_each_om_fused_site(tmp_path):
    """dla_34 pallas_full at 64x64, where the 5 calls of the 64->64 site
    at stride 4 take the om-fused kernel (``site_om_fused``): one operator
    node per call, and the round trip bit-equal to eager."""
    det = Detector(_cfg("dla_34"), state_dict_from_npz(NPZ), device="cpu")
    x = _images(1, seed=7)
    calls = []
    real = dc.dcn_v2_fused_op

    def spy(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    with mock.patch.object(dc, "dcn_v2_fused_op", spy):
        want = det.process(x)
    assert calls == [(1, RES // 4, RES // 4, 64)] * 5
    program, served = _round_trip(det, x, tmp_path / "dla.pt2")
    nodes = [n for n in program.graph.nodes if n.target is OP]
    assert len(nodes) == len(calls)
    loaded = [n for n in served.program.graph.nodes if n.target is OP]
    assert len(loaded) == len(calls)
    assert torch.equal(served(x), want)


def _cli(tmp_path, capsys, *args):
    export_cli.main(["--device", "cpu", *args, "model.name", "res_18",
                     "model.input_res", str(RES),
                     "model.output_res", str(RES // 4)])
    return capsys.readouterr().out


def test_export_cli_round_trip_and_load(tmp_path, capsys):
    out = str(tmp_path / "res18.pt2")
    text = _cli(tmp_path, capsys, "--format", "export", "--out", out,
                "--batch", "1")
    assert Path(out).stat().st_size > 1000
    assert "round-trip OK" in text and "equal to eager: True" in text
    export_cli.main(["--load", out])
    text = capsys.readouterr().out
    assert "ran on cpu" in text and "dets (1, 100, 40)" in text


@pytest.mark.slow  # Inductor's C++ compile: about a minute on the CPU
def test_export_cli_aot(tmp_path, capsys):
    text = _cli(tmp_path, capsys, "--format", "aot", "--batch", "1")
    assert "flops per call" in text and "executed OK" in text
