"""``model.dcn_fused_om: false`` against the reference with the same
switch: dla_34 bf16 under ``pallas_full`` at 64x64, where the reference's
inference sites leave the om-fused kernel and take the explicit path (the
offset/mask conv and its bias in bf16, the sigmoid, then
``dcn_v2_pallas`` where ``pallas_supported`` takes the site, else the XLA
op).  The reference's Pallas calls run in interpret mode, as its own tests
run them on the CPU, in one jitted forward that also hands out each DCN
call's input, offsets, mask and output; each port site is fed the
reference's input.  ``tools/offsets_hist`` reads the explicit path's
offsets under the switch."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import centerpose_tpu.models.dla as jdla
import centerpose_tpu.ops.dcn_pallas as dp
import centerpose_tpu_torch.models.dla as tdla
from centerpose_tpu.models.factory import create_model as j_create
from centerpose_tpu_torch.models.common import to_compute_dtype
from centerpose_tpu_torch.tools.offsets_hist import record_offsets

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import jax_cfg, jax_variables, rel_err, torch_cfg, torch_model

RES = 64
CALLS = 16  # DCN calls of one dla_34 forward
HEADS = ("hm", "wh", "hps", "reg", "hm_hp", "hp_offset")
BF16_ULP = 2.0 ** -8  # bf16's spacing relative to the value


def _image() -> np.ndarray:
    return np.random.default_rng(11).normal(size=(1, RES, RES, 3)).astype(
        np.float32)


def _port_model():
    cfg = torch_cfg(RES, "pallas_full", compute_dtype="bfloat16",
                    dcn_fused_om=False)
    return to_compute_dtype(torch_model(cfg), torch.bfloat16)


@pytest.fixture(scope="module")
def reference():
    """The reference's jitted bf16 forward with ``dcn_fused_om`` off: its
    heads, and for each DCN call in order (kind, x, offset, mask, y), x
    NHWC as the DCN op reads it."""
    model = j_create(jax_cfg(RES, "pallas_full", compute_dtype="bfloat16",
                             dcn_fused_om=False))
    kinds = []

    def run(v, x):
        seen = []

        def spy(kind, real):
            def call(x_, offset, mask, *a, **k):
                y = real(x_, offset, mask, *a, **k)
                seen.append((x_, offset, mask, y))
                kinds.append(kind)
                return y
            return call

        with mock.patch.object(dp, "dcn_v2_pallas",
                               spy("pallas", dp.dcn_v2_pallas)), \
                mock.patch.object(jdla, "dcn_v2", spy("xla", jdla.dcn_v2)):
            out = model.apply(v, x, train=False)
        return out, seen

    with mock.patch.object(dp, "_INTERPRET", [True]):
        heads, seen = jax.jit(run)(jax_variables(), jnp.asarray(_image()))
    calls = [(kind, *(np.array(t.astype(jnp.float32)) for t in call))
             for kind, call in zip(kinds, seen)]
    return {k: np.asarray(v) for k, v in heads.items()}, calls


@pytest.fixture(scope="module")
def port():
    """The port's model with ``dcn_fused_om`` off and its DCN modules'
    names in call order."""
    model = _port_model()
    names = {m: n for n, m in model.named_modules()
             if isinstance(m, tdla.DCN)}
    order = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: order.append(names[m])) for m in names]
    with torch.no_grad():
        heads = model(torch.from_numpy(_image()))
    for h in hooks:
        h.remove()
    return model, order, {k: v.numpy() for k, v in heads.items()}


def _bf16_step(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))) * BF16_ULP


def test_reference_sites_leave_the_fused_kernel(reference):
    """With the switch off the reference hands every call explicit
    offsets: 11 through ``dcn_v2_pallas`` (clamped), 5 unclamped XLA
    calls at the sites outside ``pallas_supported``."""
    _, calls = reference
    kinds = [c[0] for c in calls]
    assert len(kinds) == CALLS
    assert kinds.count("pallas") == 11 and kinds.count("xla") == 5


@pytest.mark.parametrize("call", range(CALLS))
def test_site_rounds_om_and_computes_as_reference(reference, port, call):
    """Each port site, fed the reference's input for that call, hands
    ``dcn_v2`` (K2) the reference's offsets and mask: within one bf16 step
    (as ``tests/test_torch_dla_site.py`` holds the ``xla`` sites) and more
    than 99.9% equal; its output within 1e-2 of the reference's."""
    model, order, _ = port
    _, x, want_off, want_mask, want_y = reference[1][call]
    site = model.get_submodule(order[call])
    real, seen = tdla.dcn_v2, {}

    def spy(x_, offset, mask, *a):
        seen.update(offset=offset.float().numpy(), mask=mask.float().numpy())
        return real(x_, offset, mask, *a)

    xt = torch.tensor(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with mock.patch.object(tdla, "dcn_v2", spy), torch.no_grad():
        y = site(xt.contiguous(memory_format=torch.channels_last))
    assert seen, (f"{order[call]}: the eval site with dcn_fused_om off did "
                  "not take the explicit offset/mask path")
    got_off, got_mask = seen["offset"], seen["mask"]
    assert got_off.shape == want_off.shape
    omb = site.conv_offset_mask.bias.detach().to(torch.bfloat16).float()
    step = (_bf16_step(np.abs(want_off) + np.abs(omb[:18].numpy()))
            + _bf16_step(want_off))
    assert np.all(np.abs(got_off - want_off) <= step), order[call]
    assert np.all(np.abs(got_mask - want_mask) <= _bf16_step(want_mask))
    equal = np.concatenate([(got_off == want_off).ravel(),
                            (got_mask == want_mask).ravel()])
    assert equal.mean() > 0.999, (order[call], equal.mean())
    got_y = y.permute(0, 2, 3, 1).float().numpy()
    assert rel_err(got_y, want_y) < 1e-2, order[call]


def test_heads_match_reference(reference, port):
    want, _ = reference
    got = port[2]
    for name in HEADS:
        assert got[name].shape == want[name].shape
        # both round each activation to bf16, summing in another order
        assert rel_err(got[name], want[name]) < 1e-2, name


def test_offsets_hist_reads_the_explicit_offsets():
    """``tools/offsets_hist.record_offsets`` under the switch keeps, at
    every site, the offsets that the explicit path hands to ``dcn_v2``."""
    model = _port_model()
    x = torch.from_numpy(_image())
    real, handed = tdla.dcn_v2, []

    def spy(x_, offset, *a):
        handed.append(offset.float())
        return real(x_, offset, *a)

    with mock.patch.object(tdla, "dcn_v2", spy), torch.no_grad():
        model(x)
    with record_offsets(model) as kept, torch.no_grad():
        model(x)
    assert len(handed) == CALLS and len(kept) == CALLS
    for got, want in zip(kept.values(), handed):
        assert len(got) == 1 and torch.equal(got[0], want)
