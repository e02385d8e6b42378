"""Whole-model parity: dla_34 with the real f16 snapshot, the port against
the JAX package on the same input, all six heads, then decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import centerpose_tpu.ops.dcn_pallas as dp
from centerpose_tpu.losses import sigmoid_clamped as j_sigmoid
from centerpose_tpu.models.factory import create_model as j_create
from centerpose_tpu.ops.decode import multi_pose_decode as j_decode
from centerpose_tpu_torch.losses import sigmoid_clamped
from centerpose_tpu_torch.models.common import to_compute_dtype
from centerpose_tpu_torch.models.dla import DCN
from centerpose_tpu_torch.ops.decode import multi_pose_decode

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import jax_cfg, jax_variables, rel_err, torch_cfg, torch_model

HEADS = ("hm", "wh", "hps", "reg", "hm_hp", "hp_offset")


def _image(res, b=2, seed=11):
    return np.random.default_rng(seed).normal(size=(b, res, res, 3)).astype(
        np.float32)


def _jax_heads(res, impl, x, **model_cfg):
    model = j_create(jax_cfg(res, impl, **model_cfg))
    out = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        jax_variables(), jnp.asarray(x))
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_heads(res, impl, x):
    model = torch_model(torch_cfg(res, impl))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return {k: v.numpy() for k, v in out.items()}


def _decode(heads, sig, dec, conv):
    h = {k: conv(v) for k, v in heads.items()}
    return np.asarray(dec(sig(h["hm"]), h["wh"], h["hps"], h["reg"],
                          sig(h["hm_hp"]), h["hp_offset"], k=100))


@pytest.fixture(scope="module")
def heads128():
    x = _image(128)
    return {"jax_xla": _jax_heads(128, "xla", x),
            "port_pallas_full": _torch_heads(128, "pallas_full", x),
            "port_xla": _torch_heads(128, "xla", x)}


@pytest.mark.parametrize("port", ["port_pallas_full", "port_xla"])
def test_dla34_128_heads_match_jax_xla(heads128, port):
    ref = heads128["jax_xla"]
    got = heads128[port]
    for name in HEADS:
        assert got[name].shape == ref[name].shape
        # f32 on both sides: conv and GEMM summation order only.  Under the
        # pallas_full policy the clamped sites give the same function here
        # because the snapshot's learned |dy| stays inside R at 128x128.
        assert rel_err(got[name], ref[name]) < 1e-4, name


def test_dla34_128_decode_matches_jax(heads128):
    got = _decode(heads128["port_pallas_full"], sigmoid_clamped,
                  multi_pose_decode, torch.from_numpy)
    want = _decode(heads128["jax_xla"], j_sigmoid, j_decode, jnp.asarray)
    assert got.shape == want.shape == (2, 100, 40)
    np.testing.assert_allclose(got[:, :, 4], want[:, :, 4], atol=1e-5)
    # rows of distinct-score detections agree in full (boxes, joints)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_dla34_128_bf16_matches_jax_bf16():
    x = _image(128, b=1)
    ref = _jax_heads(128, "xla", x, compute_dtype="bfloat16")
    model = to_compute_dtype(
        torch_model(torch_cfg(128, "xla", compute_dtype="bfloat16")),
        torch.bfloat16)
    # as the reference: BN parameters and statistics and the DCN bias stay
    # float32 (they are not rounded to bf16), the conv and DCN weights
    # take the compute dtype
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert all(t.dtype == torch.float32 for t in
                       (m.weight, m.bias, m.running_mean, m.running_var))
        if isinstance(m, DCN):
            assert m.bias.dtype == torch.float32
            assert m.weight.dtype == torch.bfloat16
        if isinstance(m, torch.nn.Conv2d):
            assert m.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}
    for name in HEADS:
        assert got[name].dtype == np.float32
        # both round every activation to bf16 (8 significant bits), in a
        # different order of summation; each is ~1e-2 from its f32 heads on
        # this input, and the two are 1.4e-2 apart (measured on CPU)
        assert rel_err(got[name], ref[name]) < 3e-2, name


@pytest.mark.slow
def test_dla34_128_port_matches_jax_pallas_full_interpret():
    x = _image(128, b=1)
    dp._INTERPRET[0] = True
    try:
        ref = _jax_heads(128, "pallas_full", x)
    finally:
        dp._INTERPRET[0] = False
    got = _torch_heads(128, "pallas_full", x)
    for name in HEADS:
        # the Pallas kernels project in bf16 (see test_torch_dcn.py)
        assert rel_err(got[name], ref[name]) < 5e-2, name


@pytest.mark.slow
def test_dla34_512_heads_match_jax_xla():
    x = _image(512, b=1)
    ref = _jax_heads(512, "xla", x)
    got = _torch_heads(512, "xla", x)
    for name in HEADS:
        assert rel_err(got[name], ref[name]) < 1e-4, name
