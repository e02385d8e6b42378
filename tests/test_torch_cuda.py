"""The CUDA kernels (K1, K2 and the backward) against their plain
versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip.  On the card
(JAX is not needed, so the JAX test configuration is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see module doc)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(seed, b, h, w, cin, cout, dtype, dev, om_scale=8.0):
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(b, h, w, cin)),
            r.normal(size=(3, 3, cin, 27)) * om_scale / np.sqrt(9 * cin),
            r.normal(size=(27,)),
            r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin),
            r.normal(size=(cout,)))
    # the bias stays float32 (the kernel adds it before the output rounding)
    return [torch.tensor(a, dtype=dtype if i < 4 else torch.float32,
                         device=dev) for i, a in enumerate(arrs)]


# ragged shapes: pixels not a multiple of the 64-pixel tile, Cin not a
# multiple of the 32-channel slice, Cout not a multiple of the 64 tile
@pytest.mark.parametrize("b,h,w,cin,cout,r", [
    (1, 5, 7, 3, 5, None), (2, 9, 13, 40, 70, 2.0), (1, 16, 16, 512, 256, 24),
    (2, 32, 48, 96, 130, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, b, h, w, cin, cout, r, dtype):
    args = _args(cin + cout, b, h, w, cin, cout, dtype, cuda)
    dc.reset_launch_counts()
    got = dc.dcn_v2_fused(*args, r)
    assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL
    ref = dcn_v2_fused_plain(*args, r)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # f32: summation order only; bf16: the final rounding (an ulp or two)
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2) * scale


def test_k1_rejects_bad_operands(cuda):
    args = _args(0, 1, 8, 8, 16, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        dc.dcn_v2_fused(args[0].half(), *[a.half() for a in args[1:]], None)
    with pytest.raises(TypeError):
        dc.dcn_v2_fused(args[0], args[1].bfloat16(), *args[2:], None)
    with pytest.raises(TypeError):
        dc.dcn_v2_fused(*args[:4], args[4].bfloat16(), None)
    with pytest.raises(ValueError):
        dc.dcn_v2_fused(args[0].permute(0, 2, 1, 3), *args[1:], None)
    with pytest.raises(ValueError):
        dc.dcn_v2_fused(args[0], args[1][:, :, :8], *args[2:], None)


def _train_args(seed, b, h, w, cin, cout, dtype, dev, r):
    """x, offset (std 1.5 R, so the clamp binds), sigmoid-ed mask, weight,
    f32 bias, cotangent."""
    g = np.random.default_rng(seed)
    arrs = (g.normal(size=(b, h, w, cin)),
            g.normal(size=(b, h, w, 18)) * 1.5 * (r or 4),
            1 / (1 + np.exp(-g.normal(size=(b, h, w, 9)))),
            g.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin),
            g.normal(size=(cout,)),
            g.normal(size=(b, h, w, cout)))
    return [torch.tensor(a, dtype=torch.float32 if i == 4 else dtype,
                         device=dev) for i, a in enumerate(arrs)]


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-12)).item()


# f32: summation order, and atomics in a varying order for dx, dW, dbias;
# bf16: one rounding of each output to bf16 (and of the dW columns)
_TOL_FWD = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
_TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_SHAPES = [(1, 5, 7, 3, 5, None), (2, 9, 13, 40, 70, 2.0),
           (1, 16, 16, 512, 256, 24), (2, 32, 48, 96, 130, 0.5)]


@pytest.mark.parametrize("b,h,w,cin,cout,r", _SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_and_backward_match_plain(cuda, b, h, w, cin, cout, r, dtype):
    from centerpose_tpu_torch.ops.dcn import dcn_v2, dcn_v2_backward_plain

    x, off, mask, wgt, bias, ct = _train_args(cin + cout, b, h, w, cin, cout,
                                              dtype, cuda, r)
    dc.reset_launch_counts()
    y = dc.dcn_v2(x, off, mask, wgt, bias, r)
    grads = dc.dcn_v2_backward(x, off, mask, wgt, ct, r)
    assert dc.dcn_v2.launches == 1 and dc.dcn_v2_backward.launches == 1
    ref = dcn_v2(x, off, mask, wgt, bias, r)
    refs = dcn_v2_backward_plain(x, off, mask, wgt, ct, r)
    torch.cuda.synchronize()
    assert y.dtype == dtype and _rel(y, ref) <= _TOL_FWD[dtype]
    for name, a, want in zip(("dx", "doff", "dmask", "dW", "dbias"), grads,
                             refs):
        assert a.dtype == want.dtype and a.shape == want.shape, name
        assert _rel(a, want) <= _TOL_BWD[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_function_gradient_launches_the_backward(cuda, dtype):
    x, off, mask, wgt, bias, ct = _train_args(1, 2, 16, 16, 32, 48, dtype,
                                              cuda, 3.0)
    leaves = [t.clone().requires_grad_() for t in (x, off, mask, wgt, bias)]
    dc.reset_launch_counts()
    y = dc.dcn_v2(*leaves, 3.0)
    y.backward(ct)
    assert dc.dcn_v2.launches == 1 and dc.dcn_v2_backward.launches == 1
    want = dc.dcn_v2_backward(x, off, mask, wgt, ct, 3.0)
    for leaf, g in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert _rel(leaf.grad, g) <= _TOL_BWD[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_function_gradient_matches_plain(cuda, dtype):
    """Gradients flow through the om-fused K1 on the card (the backward
    kernel on K1's om, then the om conv's VJP) and match the plain path's
    autograd."""
    args = _args(3, 2, 16, 16, 32, 48, dtype, cuda, om_scale=4.0)
    ct = torch.randn(2, 16, 16, 48, device=cuda, dtype=dtype)
    outs = []
    for fn in (dc.dcn_v2_fused, dcn_v2_fused_plain):
        leaves = [t.clone().requires_grad_() for t in args]
        dc.reset_launch_counts()
        y = fn(*leaves, 6.0)
        y.backward(ct)
        outs.append([t.grad for t in leaves])
        if fn is dc.dcn_v2_fused:
            assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL
            assert dc.dcn_v2_backward.launches == 1
    # bf16: the kernel samples at K1's f32 om, the plain path at its f32
    # conv: the same offsets up to summation order
    for got, want in zip(*outs):
        assert got is not None and got.dtype == want.dtype
        assert _rel(got, want) <= _TOL_BWD[dtype]
