"""Port parity of the DCNv2 ops: the plain K1 (om-fused forward) against the
JAX Pallas kernel in interpret mode and against the f32 XLA clamped chain,
the plain dcn_v2 against JAX dcn_v2, and the fixed bilinear upsample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import centerpose_tpu.ops.dcn_pallas as dp
from centerpose_tpu.models.dla import bilinear_upsample as j_upsample
from centerpose_tpu.ops.dcn import dcn_v2 as j_dcn_v2
from centerpose_tpu_torch.models.dla import bilinear_upsample
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import dcn_v2, dcn_v2_fused_plain

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import rel_err


def _case(seed, b, h, w, cin, cout, om_scale=0.3):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, h, w, cin)).astype(np.float32)
    omw = (r.normal(size=(3, 3, cin, 27)) * om_scale).astype(np.float32)
    omb = r.normal(size=(27,)).astype(np.float32)
    wgt = (r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = r.normal(size=(cout,)).astype(np.float32)
    return x, omw, omb, wgt, bias


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _xla_fused_chain(x, omw, omb, wgt, bias, md):
    """The JAX package's f32 reference chain of the fused op: explicit
    offset/mask conv -> dy clipped to +-md -> dcn_v2."""
    om = lax.conv_general_dilated(
        x, omw, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + omb
    off = om[..., :18].reshape(*om.shape[:-1], 9, 2)
    off = jnp.stack([jnp.clip(off[..., 0], -md, md), off[..., 1]], -1)
    return j_dcn_v2(x, off.reshape(*om.shape[:-1], 18),
                    jax.nn.sigmoid(om[..., 18:]), wgt, bias)


@pytest.mark.parametrize("h,w,cin,cout", [(16, 128, 8, 8),   # row-major
                                          (16, 32, 8, 16)])  # row-grouped
def test_plain_k1_matches_pallas_interpret(h, w, cin, cout):
    x, omw, omb, wgt, bias = _case(200 + w, 2, h, w, cin, cout)
    md = dp.resolve_max_dy(h, w, cin, cout)
    assert dp.fused_om_supported(h, w, cin, cout)
    assert dc.site_max_dy(h, w, cin, cout, "pallas_full") == md
    dp._INTERPRET[0] = True
    try:
        ref = np.asarray(dp.dcn_v2_pallas_fused(
            *map(jnp.asarray, (x, omw, omb, wgt, bias))))
    finally:
        dp._INTERPRET[0] = False
    got = dcn_v2_fused_plain(*_t(x, omw, omb, wgt, bias), md).numpy()
    # the Pallas kernel projects om and the tap products in bf16; a bf16
    # om moves bilinear corners at knife edges (tests/test_dcn.py uses the
    # same bound for the kernel against the f32 chain)
    assert rel_err(got, ref) < 2e-2


@pytest.mark.parametrize("h,w,cin,cout,md", [(16, 128, 8, 8, 6),
                                             (32, 32, 8, 16, 12),
                                             (8, 16, 16, 8, 1)])
def test_plain_k1_matches_f32_xla_chain(h, w, cin, cout, md):
    # om_scale 3 makes |dy| exceed md at many taps, so the clamp matters
    x, omw, omb, wgt, bias = _case(300 + md, 2, h, w, cin, cout, om_scale=3.0)
    ref = np.asarray(_xla_fused_chain(*map(jnp.asarray, (x, omw, omb, wgt, bias)),
                                      float(md)))
    got = dcn_v2_fused_plain(*_t(x, omw, omb, wgt, bias), md).numpy()
    # both f32; only the summation order of conv and GEMM differs
    assert rel_err(got, ref) < 1e-5
    unclamped = dcn_v2_fused_plain(*_t(x, omw, omb, wgt, bias), None).numpy()
    assert rel_err(unclamped, ref) > 1e-3  # the clamp was exercised


@pytest.mark.parametrize("max_dy", [None, 2.0])
def test_plain_dcn_v2_matches_jax(max_dy):
    r = np.random.default_rng(7)
    b, h, w, cin, cout = 2, 12, 20, 6, 5
    x = r.normal(size=(b, h, w, cin)).astype(np.float32)
    off = (r.normal(size=(b, h, w, 18)) * 4.0).astype(np.float32)
    mask = (1 / (1 + np.exp(-r.normal(size=(b, h, w, 9))))).astype(np.float32)
    wgt = r.normal(size=(3, 3, cin, cout)).astype(np.float32)
    bias = r.normal(size=(cout,)).astype(np.float32)
    joff = off
    if max_dy is not None:
        o = off.reshape(b, h, w, 9, 2).copy()
        o[..., 0] = np.clip(o[..., 0], -max_dy, max_dy)
        joff = o.reshape(off.shape)
    ref = np.asarray(j_dcn_v2(*map(jnp.asarray, (x, joff, mask, wgt, bias))))
    got = dcn_v2(*_t(x, off, mask, wgt, bias), max_dy=max_dy).numpy()
    # f32 both sides, offsets up to ~12 cells: many corners off the image
    assert rel_err(got, ref) < 1e-5
    # bf16 inputs: computed in f32, cast back
    got16 = dcn_v2(*[t.to(torch.bfloat16) for t in _t(x, off, mask, wgt, bias)],
                   max_dy=max_dy)
    assert got16.dtype == torch.bfloat16
    assert rel_err(got16.float().numpy(), ref) < 3e-2


def test_k1_wrapper_on_cpu_is_the_plain_version():
    x, omw, omb, wgt, bias = _case(5, 1, 8, 16, 8, 8)
    args = _t(x, omw, omb, wgt, bias)
    dc.reset_launch_counts()
    got = dc.dcn_v2_fused(*args, 6)
    np.testing.assert_array_equal(got.numpy(),
                                  dcn_v2_fused_plain(*args, 6).numpy())
    assert dc.dcn_v2_fused.launches == 0  # no kernel was launched


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_bilinear_upsample_matches_jax(factor):
    x = np.random.default_rng(factor).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(j_upsample(jnp.asarray(x), factor))
    got = bilinear_upsample(torch.from_numpy(x).permute(0, 3, 1, 2), factor)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 5 * factor, 7 * factor, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
