"""Port parity of the training DCN: the plain K2 forward and its five
gradients (the plain version of the backward kernel) against the JAX
package's Pallas kernels in interpret mode and against the f32 XLA clamped
formulation; the gradient at offsets exactly on the clamp edge, per the
reference's backward dispatch; the training site policy; and the
DeformConv block in train mode (DCN + flax-style BatchNorm + ReLU) against
the JAX module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import centerpose_tpu.ops.dcn_pallas as dp
from centerpose_tpu.models.dla import DeformConv as JDeformConv
from centerpose_tpu_torch.models.dla import DeformConv
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import clamp_dy, dcn_v2, dcn_v2_backward_plain

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import rel_err

GRADS = ("dx", "doffset", "dmask", "dW", "dbias")


def _case(seed, b, h, w, cin, cout, off_scale, md):
    """Random inputs; offsets are redrawn where |dy| would sit exactly on
    the clamp radius (the gradient there is 1 for the kernels and torch,
    0.5 for jnp.clip), so the comparisons never test that knife edge."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, h, w, cin)).astype(np.float32)
    off = (r.normal(size=(b, h, w, 18)) * off_scale).astype(np.float32)
    dy = off[..., 0::2]
    dy[np.abs(np.abs(dy) - md) < 1e-3] += 0.01
    mask = (1 / (1 + np.exp(-r.normal(size=(b, h, w, 9))))).astype(np.float32)
    wgt = (r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = r.normal(size=(cout,)).astype(np.float32)
    ct = r.normal(size=(b, h, w, cout)).astype(np.float32)
    assert not np.any(np.abs(off[..., 0::2]) == md)
    assert np.mean(np.abs(off[..., 0::2]) > md) > 0.05  # the clamp binds
    return x, off, mask, wgt, bias, ct


def _port_grads(x, off, mask, wgt, bias, ct, md):
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, off, mask, wgt, bias)]
    y = dcn_v2(*leaves, max_dy=md)
    y.backward(torch.from_numpy(ct))
    return y.detach().numpy(), [t.grad.numpy() for t in leaves]


def _pallas_vjp(x, off, mask, wgt, bias, ct, md):
    dp._INTERPRET[0] = True
    try:
        y, vjp = jax.vjp(
            lambda *a: dp.dcn_v2_pallas(*a, 1, 1, 1, 1, True, md),
            *map(jnp.asarray, (x, off, mask, wgt, bias)))
        return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    finally:
        dp._INTERPRET[0] = False


def _check_against_pallas(h, w, cin, cout, md):
    x, off, mask, wgt, bias, ct = _case(h + w + cin, 1, h, w, cin, cout,
                                        4.0, md)
    y_ref, g_ref = _pallas_vjp(x, off, mask, wgt, bias, ct, md)
    y, g = _port_grads(x, off, mask, wgt, bias, ct, md)
    # the Pallas kernels build their one-hot/band matrices and the sampled
    # rows in bf16 (native MXU precision): ~1e-2 of the f32 result at
    # worst (tests/test_dcn.py holds them to the same bound)
    assert rel_err(y, y_ref) < 2e-2
    for name, a, b in zip(GRADS, g, g_ref):
        assert rel_err(a, b) < 2e-2, name


def test_plain_k2_and_grads_match_pallas_grouped_interpret():
    h, w, cin, cout, md = 16, 16, 8, 16, 3
    assert dp._grouped_ok(h, w, cin, cout, md)
    assert dp._grouped_bwd_ok(h, w, cin, cout, md)  # the K3 path
    _check_against_pallas(h, w, cin, cout, md)


@pytest.mark.slow
def test_plain_k2_and_grads_match_pallas_rowmajor_interpret():
    # tests/test_dcn.py's split-backward shape: K2a forward, K4 + K5
    h, w, cin, cout = 8, 128, 4, 4
    md = dp.resolve_max_dy(h, w, cin, cout)
    assert dp._rowmajor_split_ok(h, w, cin, cout, md)
    assert not dp._grouped_bwd_ok(h, w, cin, cout, md)
    _check_against_pallas(h, w, cin, cout, md)


@pytest.mark.parametrize("h,w,cin,cout,md", [(8, 12, 6, 5, 2.0),
                                             (16, 16, 8, 4, 6.0)])
def test_plain_grads_match_xla_clamped_vjp(h, w, cin, cout, md):
    x, off, mask, wgt, bias, ct = _case(7 + h, 2, h, w, cin, cout, 5.0, md)
    _, vjp = jax.vjp(
        lambda *a: dp._xla_fwd_clamped(*a, stride=1, padding=1, dilation=1,
                                       g=1, max_dy=md),
        *map(jnp.asarray, (x, off, mask, wgt, bias)))
    g_ref = [np.asarray(t) for t in vjp(jnp.asarray(ct))]
    _, g = _port_grads(x, off, mask, wgt, bias, ct, md)
    # both f32 autodiff of one formulation: summation order only
    for name, a, b in zip(GRADS, g, g_ref):
        assert rel_err(a, b) < 1e-5, name
    # and the clamp binds: the dy gradient is zero exactly where |dy| > R
    dy_grad = g[1][..., 0::2]
    assert np.all(dy_grad[np.abs(off[..., 0::2]) > md] == 0)
    assert np.any(dy_grad[np.abs(off[..., 0::2]) < md] != 0)


def test_clamp_passes_gradient_inclusively():
    off = torch.tensor([[-3.5, 0.1, -3.0, 0.2, 2.0, 0.3, 3.0, 0.4, 3.5, 0.5]
                        + [0.0] * 8], requires_grad=True)
    clamp_dy(off, 3.0).sum().backward()
    # dy at -3.5 and 3.5 is clipped (no gradient); at exactly +-3 it
    # passes, as the kernels' clamp_pass; every dx passes
    want = [0, 1, 1, 1, 1, 1, 1, 1, 0, 1] + [1] * 8
    np.testing.assert_array_equal(off.grad.numpy()[0], want)


def test_backward_wrapper_on_cpu_is_the_plain_version():
    x, off, mask, wgt, bias, ct = _case(3, 1, 8, 8, 4, 4, 3.0, 2.0)
    args = [torch.from_numpy(a) for a in (x, off, mask, wgt)]
    dc.reset_launch_counts()
    got = dc.dcn_v2_backward(*args, torch.from_numpy(ct), 2.0)
    want = dcn_v2_backward_plain(*args, torch.from_numpy(ct), 2.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    y = dc.dcn_v2(*args, torch.from_numpy(bias), 2.0)
    np.testing.assert_array_equal(
        y.numpy(), dcn_v2(*args, torch.from_numpy(bias), 2.0).numpy())
    assert all(fn.launches == 0 for fn in dc.COUNTED)  # no kernel launched
    # bf16 inputs: every gradient comes back in its input's dtype
    g16 = dc.dcn_v2_backward(*[a.bfloat16() for a in args],
                             torch.from_numpy(ct).bfloat16(), 2.0)
    assert [t.dtype for t in g16] == [torch.bfloat16] * 4 + [torch.float32]


def _edge_case(seed, h, w, cin, cout, md, frac=0.15):
    """Random inputs with about ``frac`` of the dy offsets exactly on
    +-md (the rest off it by more than 1e-3)."""
    x, off, mask, wgt, bias, ct = _case(seed, 1, h, w, cin, cout, 0.8 * md,
                                        md)
    r = np.random.default_rng(seed + 1)
    dy = off[..., 0::2]
    pick = r.random(dy.shape) < frac
    dy[pick] = np.where(dy[pick] < 0, -md, md)
    off[..., 0::2] = dy
    on = np.zeros(off.shape, bool)
    on[..., 0::2] = np.abs(off[..., 0::2]) == md
    assert on.sum() > 10
    return (x, off, mask, wgt, bias, ct), on


def _edge_grads(args, md, edge):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    y = dcn_v2(*leaves, max_dy=md, edge_grad=edge)
    y.backward(torch.from_numpy(args[5]))
    return [t.grad.numpy() for t in leaves]


def test_edge_gradient_at_a_fallback_site_is_half():
    """24x24, 8->8, R=6: neither of the reference's backward kernels takes
    it (``_bwd_core`` falls back to the VJP of ``_xla_fwd_clamped``, whose
    ``jnp.clip`` passes 0.5 on the edge); the port's site function gives
    0.5 and its gradients match the reference's ``dcn_v2_pallas`` VJP."""
    h, w, cin, cout, md = 24, 24, 8, 8, 6
    assert dp.pallas_supported(h, w, cin, cout, max_dy=md)
    assert not dp._grouped_bwd_ok(h, w, cin, cout, md)
    assert not dp._rowmajor_split_ok(h, w, cin, cout, md)
    edge = dc.train_site_edge_grad(h, w, cin, cout, "pallas_full", md)
    assert edge == 0.5
    args, on = _edge_case(5, h, w, cin, cout, md)
    _, g_ref = _pallas_vjp(*args, md)
    g = _edge_grads(args, md, edge)
    # both f32 autodiff of one formulation: summation order only
    for name, a, b in zip(GRADS, g, g_ref):
        assert rel_err(a, b) < 1e-5, name
    assert np.any(g_ref[1][on] != 0)
    # the full gradient on the edge would not match
    g1 = _edge_grads(args, md, 1.0)
    np.testing.assert_allclose(g[1][on], 0.5 * g1[1][on], rtol=1e-6)
    assert rel_err(g1[1], g_ref[1]) > 1e-2


def test_edge_gradient_at_a_k3_site_is_one():
    """16x16, 8->16, R=3: the reference's fused grouped backward (K3, run
    in interpret mode) takes it and its clamp passes 1 on the edge; the
    port's site function gives 1 and its gradients match."""
    h, w, cin, cout, md = 16, 16, 8, 16, 3
    assert dp._grouped_bwd_ok(h, w, cin, cout, md)
    edge = dc.train_site_edge_grad(h, w, cin, cout, "pallas_full", md)
    assert edge == 1.0
    args, on = _edge_case(6, h, w, cin, cout, md)
    _, g_ref = _pallas_vjp(*args, md)
    g = _edge_grads(args, md, edge)
    # the Pallas kernels' bf16 one-hot/band products: ~1e-2 of the f32
    # result at worst, as in _check_against_pallas
    for name, a, b in zip(GRADS, g, g_ref):
        assert rel_err(a, b) < 2e-2, name
    # half the gradient on the edge would not match
    g5 = _edge_grads(args, md, 0.5)
    assert rel_err(g5[1], g_ref[1]) > 5e-2


_SITES_BY_STRIDE = [(512, 256, 32), (256, 256, 16), (256, 128, 16),
                    (128, 128, 8), (128, 64, 8), (256, 64, 16), (64, 64, 4)]


@pytest.mark.parametrize("impl", ["pallas", "pallas_full"])
@pytest.mark.parametrize("res", [128, 384, 512, 640])
@pytest.mark.parametrize("cin,cout,stride", _SITES_BY_STRIDE)
def test_backward_dispatch_matches_reference(cin, cout, stride, res, impl):
    """The port's copy of the reference's backward predicates, and the edge
    gradient they give a clamped site: 1 where ``_bwd_core`` runs K3 or
    K4+K5 (``kernel_bwd`` under pallas_full), 0.5 where it falls back to
    the clip VJP."""
    h = res // stride
    md = dp.resolve_max_dy(h, h, cin, cout)
    assert dc.resolve_max_dy(h, h, cin, cout) == md
    assert dc._grouped_bwd_ok(h, h, cin, cout, md) == dp._grouped_bwd_ok(
        h, h, cin, cout, md)
    assert dc._rowmajor_split_ok(h, h, cin, cout, md) == dp._rowmajor_split_ok(
        h, h, cin, cout, md)
    kernel = impl == "pallas_full" and (
        dp._grouped_bwd_ok(h, h, cin, cout, md)
        or dp._rowmajor_split_ok(h, h, cin, cout, md))
    clamped = dp.pallas_supported(h, h, cin, cout)
    want = 1.0 if (kernel or not clamped) else 0.5
    assert dc.train_site_edge_grad(h, h, cin, cout, impl) == want


@pytest.mark.parametrize("res", [128, 384, 512, 640])
def test_train_site_policy_matches_reference(res):
    sites = [(512, 256, 32), (256, 256, 16), (256, 128, 16), (128, 128, 8),
             (128, 64, 8), (256, 64, 16), (64, 64, 4)]
    for cin, cout, stride in sites:
        h = res // stride
        want = (dp.resolve_max_dy(h, h, cin, cout)
                if dp.pallas_supported(h, h, cin, cout) else None)
        assert dc.train_site_max_dy(h, h, cin, cout, "pallas_full") == want
        assert dc.train_site_max_dy(h, h, cin, cout, "xla") is None


@pytest.mark.parametrize("om_scale", [0.0, 0.1])
def test_deform_conv_train_mode_matches_jax(om_scale):
    """DCN (om conv + dcn_v2) -> BatchNorm on batch statistics -> ReLU, one
    VJP on a fixed cotangent, and the running statistics after it."""
    r = np.random.default_rng(11)
    b, h, w, cin, cout = 2, 8, 8, 32, 16
    x = r.normal(size=(b, h, w, cin)).astype(np.float32)
    ct = r.normal(size=(b, h, w, cout)).astype(np.float32)
    params = {
        "DCN_0": {
            "kernel": (r.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
            "bias": r.normal(size=(cout,)).astype(np.float32),
            "conv_offset_mask": {
                "kernel": (r.normal(size=(3, 3, cin, 27)) * om_scale
                           ).astype(np.float32),
                "bias": (r.normal(size=(27,)) * om_scale).astype(np.float32)}},
        "BatchNorm_0": {
            "scale": r.uniform(0.5, 1.5, size=(cout,)).astype(np.float32),
            "bias": r.normal(size=(cout,)).astype(np.float32)}}
    stats = {"BatchNorm_0": {"mean": r.normal(size=(cout,)).astype(np.float32),
                             "var": r.uniform(0.5, 2, size=(cout,)
                                              ).astype(np.float32)}}
    jm = JDeformConv(cout)

    def f(p, xx):
        return jm.apply({"params": p, "batch_stats": stats}, xx, True,
                        mutable=["batch_stats"])

    y_ref, mut = f(params, jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], params, jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(ct))

    m = DeformConv(cin, cout).train()
    with torch.no_grad():
        p = params["DCN_0"]
        m.DCN_0.weight.copy_(torch.from_numpy(p["kernel"]))
        m.DCN_0.bias.copy_(torch.from_numpy(p["bias"]))
        m.DCN_0.conv_offset_mask.weight.copy_(
            torch.from_numpy(p["conv_offset_mask"]["kernel"]))
        m.DCN_0.conv_offset_mask.bias.copy_(
            torch.from_numpy(p["conv_offset_mask"]["bias"]))
        m.BatchNorm_0.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
        m.BatchNorm_0.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
        m.BatchNorm_0.running_mean.copy_(
            torch.from_numpy(stats["BatchNorm_0"]["mean"]))
        m.BatchNorm_0.running_var.copy_(
            torch.from_numpy(stats["BatchNorm_0"]["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = m(xt)
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    # f32 on both sides, one DCN and one BatchNorm: summation order only
    assert rel_err(y.detach().permute(0, 2, 3, 1).numpy(), y_ref) < 1e-5
    assert rel_err(xt.grad.permute(0, 2, 3, 1).numpy(), g_x) < 1e-5
    gp = g_params["DCN_0"]
    for got, want in ((m.DCN_0.weight.grad, gp["kernel"]),
                      (m.DCN_0.conv_offset_mask.weight.grad,
                       gp["conv_offset_mask"]["kernel"]),
                      (m.DCN_0.conv_offset_mask.bias.grad,
                       gp["conv_offset_mask"]["bias"]),
                      (m.BatchNorm_0.weight.grad,
                       g_params["BatchNorm_0"]["scale"]),
                      (m.BatchNorm_0.bias.grad,
                       g_params["BatchNorm_0"]["bias"])):
        assert rel_err(got.numpy(), want) < 1e-5
    # the DCN bias feeds a BatchNorm on batch statistics: its gradient is
    # zero up to rounding on both sides (flax's E[x^2] - E[x]^2 variance
    # rounds more), tiny beside the weight's
    scale = np.abs(np.asarray(gp["kernel"])).max()
    assert np.abs(m.DCN_0.bias.grad.numpy()).max() < 1e-5 * scale
    assert np.abs(np.asarray(gp["bias"])).max() < 1e-4 * scale
    # running statistics: flax's update with the biased batch variance
    new = mut["batch_stats"]["BatchNorm_0"]
    assert rel_err(m.BatchNorm_0.running_mean.numpy(), new["mean"]) < 1e-6
    assert rel_err(m.BatchNorm_0.running_var.numpy(), new["var"]) < 1e-6
