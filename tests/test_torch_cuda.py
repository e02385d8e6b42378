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
    assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL[dtype]
    ref = dcn_v2_fused_plain(*args, r)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # f32: summation order only; bf16: the final rounding (an ulp or two)
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2) * scale


# bf16 launch plans: (shape, split) with the reduction split across a
# cluster (few tiles) and not (enough tiles to fill the card), each with
# ragged Cin or Cout among them
_PLAN_SHAPES = [((1, 16, 16, 512, 256, 24), 8), ((2, 9, 13, 40, 70, 2.0), 5),
                ((2, 32, 48, 96, 130, 0.5), 5),
                ((2, 64, 160, 64, 64, 6.0), 1), ((1, 128, 136, 3, 5, None), 1),
                ((2, 96, 96, 128, 128, 12.0), 1)]


@pytest.mark.parametrize("shape,split", _PLAN_SHAPES)
def test_k1_k2_bf16_plans_match_plain(cuda, shape, split):
    """K1 and K2 in bf16 at split and unsplit plans against their plain
    versions, one launch per call."""
    from centerpose_tpu_torch.ops.dcn import dcn_v2

    b, h, w, cin, cout, r = shape
    plan = dc.forward_plan(torch.bfloat16, b, h, w, cin, cout)
    assert plan["split"] == split
    args = _args(cin + 2 * cout, b, h, w, cin, cout, torch.bfloat16, cuda)
    x, off, mask, wgt, bias, _ = _train_args(cin + 5 * cout, b, h, w, cin,
                                             cout, torch.bfloat16, cuda, r)
    dc.reset_launch_counts()
    got1 = dc.dcn_v2_fused(*args, r)
    got2 = dc.dcn_v2(x, off, mask, wgt, bias, r)
    assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL[torch.bfloat16]
    assert dc.dcn_v2.launches == 1
    ref1 = dcn_v2_fused_plain(*args, r)
    ref2 = dcn_v2(x, off, mask, wgt, bias, r)
    torch.cuda.synchronize()
    assert _rel(got1, ref1) <= _TOL_FWD[torch.bfloat16]
    assert _rel(got2, ref2) <= _TOL_FWD[torch.bfloat16]


@pytest.mark.parametrize("shape,split", _PLAN_SHAPES)
def test_k1_k2_are_bit_deterministic(cuda, shape, split):
    """Two calls on the same inputs give the same bits: y of K1 and K2 and
    K1's om, at split plans too (the cluster sums its partials in rank
    order)."""
    b, h, w, cin, cout, r = shape
    args = _args(cin + 2 * cout, b, h, w, cin, cout, torch.bfloat16, cuda)
    x, off, mask, wgt, bias, _ = _train_args(cin + 5 * cout, b, h, w, cin,
                                             cout, torch.bfloat16, cuda, r)
    first = dc.launch_fused_forward(*args, r)
    second = dc.launch_fused_forward(*args, r)
    k2 = [dc.dcn_v2(x, off, mask, wgt, bias, r) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])
    assert torch.equal(k2[0], k2[1])


# float32 launch plans (the FFMA kernel): (shape, split), split and not,
# ragged Cin and Cout, and Cout past 256 (column tiles, grid.y)
_PLAN_SHAPES_F32 = [((1, 16, 16, 512, 256, 24), 8),
                    ((2, 9, 13, 40, 70, 2.0), 6),
                    ((2, 32, 48, 96, 130, 0.5), 5),
                    ((2, 64, 160, 64, 64, 6.0), 1),
                    ((1, 128, 136, 3, 5, None), 1),
                    ((1, 16, 16, 64, 300, 3.0), 6),
                    ((2, 40, 40, 32, 520, None), 1)]


@pytest.mark.parametrize("shape,split", _PLAN_SHAPES_F32)
def test_k1_k2_f32_plans_match_plain(cuda, shape, split):
    """K1 and K2 in float32 at split, unsplit and column-tiled plans: one
    launch a call, y and K1's om against the plain versions, and the same
    bits on a second call."""
    from centerpose_tpu_torch.ops.dcn import dcn_v2, offset_mask

    b, h, w, cin, cout, r = shape
    f32 = torch.float32
    assert dc.forward_plan(f32, b, h, w, cin, cout)["split"] == split
    args = _args(cin + 2 * cout, b, h, w, cin, cout, f32, cuda)
    x, off, mask, wgt, bias, _ = _train_args(cin + 5 * cout, b, h, w, cin,
                                             cout, f32, cuda, r)
    dc.reset_launch_counts()
    y1, om1 = dc.launch_fused_forward(*args, r)
    z1 = dc.dcn_v2(x, off, mask, wgt, bias, r)
    assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL[f32] == 1
    assert dc.dcn_v2.launches == 1
    y2, om2 = dc.launch_fused_forward(*args, r)
    z2 = dc.dcn_v2(x, off, mask, wgt, bias, r)
    ref1 = dcn_v2_fused_plain(*args, r)
    ref2 = dcn_v2(x, off, mask, wgt, bias, r)
    off1, mask1 = offset_mask(*args[:3])
    torch.cuda.synchronize()
    assert _rel(y1, ref1) <= _TOL_FWD[f32]
    assert _rel(z1, ref2) <= _TOL_FWD[f32]
    assert _rel(om1[..., :18], off1) <= 1e-4
    assert _rel(om1[..., 18:], mask1) <= 1e-4
    assert torch.equal(y1, y2) and torch.equal(om1, om2)
    assert torch.equal(z1, z2)


def test_k1_writes_om_for_its_backward(cuda):
    """K1's om: the raw offsets and the sigmoid-ed mask of the om conv, as
    the backward reads them (the om conv is computed in the kernel)."""
    from centerpose_tpu_torch.ops.dcn import offset_mask

    for shape in ((1, 16, 16, 512, 256), (2, 64, 160, 64, 64)):
        b, h, w, cin, cout = shape
        args = _args(cin, b, h, w, cin, cout, torch.bfloat16, cuda)
        _, om = dc.launch_fused_forward(*args, 6.0)
        off, mask = offset_mask(*args[:3])
        torch.cuda.synchronize()
        assert _rel(om[..., :18], off) <= 1e-4
        assert _rel(om[..., 18:], mask) <= 1e-4


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


# f32: summation order (the kernel's is fixed, the plain version's another);
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
            assert dc.dcn_v2_fused.launches == dc.KERNELS_PER_CALL[dtype]
            assert dc.dcn_v2_backward.launches == 1
    # bf16: the kernel samples at K1's f32 om, the plain path at its f32
    # conv: the same offsets up to summation order
    for got, want in zip(*outs):
        assert got is not None and got.dtype == want.dtype
        assert _rel(got, want) <= _TOL_BWD[dtype]


def _on_edge(off, r, frac, seed):
    """Offsets with about ``frac`` of the dy components set exactly to
    +-r (in the offsets' dtype)."""
    g = torch.Generator(device=off.device).manual_seed(seed)
    dy = off[..., 0::2]
    pick = torch.rand(dy.shape, generator=g, device=off.device) < frac
    dy[pick] = torch.where(dy[pick] < 0, -float(r), float(r)).to(off.dtype)
    return int((off[..., 0::2].float().abs() == r).sum().item())


@pytest.mark.parametrize("b,h,w,cin,cout,r", [(2, 9, 13, 40, 70, 2.0),
                                              (1, 16, 16, 512, 256, 24),
                                              (2, 24, 24, 64, 64, 6.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_bit_deterministic(cuda, b, h, w, cin, cout, r, dtype):
    x, off, mask, wgt, _, ct = _train_args(cin + 3 * cout, b, h, w, cin, cout,
                                           dtype, cuda, r)
    first = dc.dcn_v2_backward(x, off, mask, wgt, ct, r)
    second = dc.dcn_v2_backward(x, off, mask, wgt, ct, r)
    torch.cuda.synchronize()
    for name, a, b2 in zip(("dx", "doff", "dmask", "dW", "dbias"), first,
                           second):
        assert torch.equal(a, b2), name


@pytest.mark.parametrize("edge", [0.5, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_edge_gradient_matches_plain(cuda, edge, dtype):
    """Offsets exactly on +-R: the kernel passes ``edge`` of the dy
    gradient there, as the plain version does."""
    from centerpose_tpu_torch.ops.dcn import dcn_v2_backward_plain

    r = 6.0
    x, off, mask, wgt, _, ct = _train_args(7, 2, 24, 24, 8, 8, dtype, cuda, r)
    assert _on_edge(off, r, 0.1, 3) > 0
    got = dc.dcn_v2_backward(x, off, mask, wgt, ct, r, edge)
    want = dcn_v2_backward_plain(x, off, mask, wgt, ct, r, edge)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "doff", "dmask", "dW", "dbias"), got, want):
        assert _rel(a, b) <= _TOL_BWD[dtype], name
    if edge != 1.0:  # exactly the edge taps' dy gradient changes
        full = dc.dcn_v2_backward(x, off, mask, wgt, ct, r, 1.0)
        on = torch.zeros_like(off, dtype=torch.bool)
        on[..., 0::2] = off[..., 0::2].float().abs() == r
        assert torch.equal(got[1].float()[on], edge * full[1].float()[on])
        assert torch.equal(got[1][~on], full[1][~on])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_long_corner_lists_match_plain(cuda, dtype):
    """Every tap of every pixel samples one point, so the four pixels
    around it receive 9 P corners each: lists longer than the dx pass
    sorts in shared memory take its slow path, with the same result."""
    from centerpose_tpu_torch.ops.dcn import dcn_v2_backward_plain

    b, h, w = 2, 8, 8
    x, off, mask, wgt, _, ct = _train_args(11, b, h, w, 24, 16, dtype, cuda,
                                           None)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    target = torch.zeros(b, h, w, 18)
    for k in range(9):
        target[..., 2 * k] = 3.25 - yy - (k // 3 - 1)
        target[..., 2 * k + 1] = 4.5 - xx - (k % 3 - 1)
    off = target.to(cuda, off.dtype).contiguous()
    got = dc.dcn_v2_backward(x, off, mask, wgt, ct, None)
    again = dc.dcn_v2_backward(x, off, mask, wgt, ct, None)
    want = dcn_v2_backward_plain(x, off, mask, wgt, ct, None)
    torch.cuda.synchronize()
    for name, a, a2, b2 in zip(("dx", "doff", "dmask", "dW", "dbias"), got,
                               again, want):
        assert torch.equal(a, a2), name
        assert _rel(a, b2) <= _TOL_BWD[dtype], name
