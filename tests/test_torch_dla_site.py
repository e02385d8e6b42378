"""One DCN site of dla_34 in eval mode, the port against the reference.

Under ``dcn_impl: xla`` the reference never runs its om-fused kernel: it
computes the offset/mask conv in the compute dtype (``models/dla.py: DCN``,
the explicit path) and XLA rounds it to bf16 after the conv, after the bias
add and after each op of the sigmoid.  The port's eval site must take the
same path and round at the same points; under ``pallas_full`` at 512x512
every site stays on the om-fused kernel (K1)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import centerpose_tpu.models.dla as jdla
import centerpose_tpu.ops.dcn_pallas as dp
import centerpose_tpu_torch.models.dla as tdla
from centerpose_tpu_torch.models.common import to_compute_dtype
from centerpose_tpu_torch.ops import dcn_cuda as dc

from _torch_port import jax_variables, torch_cfg, torch_model

# two of the 7 site shapes at 128x128 (Cin -> Cout @ HxW): 128->128 @16 and
# 64->64 @32 (the 512x512 flagship's 128->128 @64 and 64->64 @128)
SITES = ("dla_up.ida_1.node_1", "ida_up.node_1")
SITES_512 = [(512, 256, 16), (256, 256, 32), (256, 128, 32), (128, 128, 64),
             (128, 64, 64), (256, 64, 32), (64, 64, 128)]
BF16_ULP = 2.0 ** -8  # bf16's spacing relative to the value (8 significand bits)


def _node(tree: dict, path: str) -> dict:
    for part in path.split("."):
        tree = tree[part]
    return tree


@pytest.fixture(scope="module")
def site_inputs():
    """Each site's input from the float32 port model on a seeded image,
    rounded to bf16 as the bf16 model hands it on."""
    model = torch_model(torch_cfg(128, "xla"))
    got = {}
    hooks = [model.get_submodule(p).register_forward_hook(
        lambda m, a, out, p=p: got.__setitem__(p, a[0].detach()))
        for p in SITES]
    x = np.random.default_rng(11).normal(size=(1, 128, 128, 3))
    with torch.no_grad():
        model(torch.from_numpy(x.astype(np.float32)))
    for h in hooks:
        h.remove()
    return {p: t.permute(0, 2, 3, 1).to(torch.bfloat16).float().numpy()
            for p, t in got.items()}


def _reference_site(path: str, x: np.ndarray):
    """The reference's DeformConv(impl="xla", bf16) at ``path``, jitted, with
    the offsets and the mask it hands to ``dcn_v2``."""
    variables = jax_variables()
    v = {g: _node(variables[g], path) for g in ("params", "batch_stats")}
    cout = v["params"]["DCN_0"]["kernel"].shape[-1]
    mod = jdla.DeformConv(cout, dcn_impl="xla", dtype=jnp.bfloat16)
    real = jdla.dcn_v2

    def run(v, x):
        seen = {}

        def spy(x_, offset, mask, *a, **k):
            seen.update(offset=offset, mask=mask)
            return real(x_, offset, mask, *a, **k)

        with mock.patch.object(jdla, "dcn_v2", spy):
            y = mod.apply(v, x, train=False)
        return y, seen["offset"], seen["mask"]

    y, off, mask = jax.jit(run)(v, jnp.asarray(x, jnp.bfloat16))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(off.astype(jnp.float32)),
            np.asarray(mask.astype(jnp.float32)))


def _port_site(path: str, x: np.ndarray):
    """The port's DeformConv at ``path`` in bf16 eval mode, with the offsets
    and the mask its DCN hands to ``dcn_v2`` (None where it hands none)."""
    model = to_compute_dtype(
        torch_model(torch_cfg(128, "xla", compute_dtype="bfloat16")),
        torch.bfloat16)
    site = model.get_submodule(path)
    real = tdla.dcn_v2
    seen = {}

    def spy(x_, offset, mask, *a, **k):
        seen.update(offset=offset, mask=mask)
        return real(x_, offset, mask, *a, **k)

    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with mock.patch.object(tdla, "dcn_v2", spy), torch.no_grad():
        y = site(xt.contiguous(memory_format=torch.channels_last))
    y = y.permute(0, 2, 3, 1).float().numpy()
    if not seen:
        return y, None, None
    return (y, seen["offset"].float().numpy(), seen["mask"].float().numpy())


def _bf16_step(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))) * BF16_ULP


@pytest.mark.parametrize("path", SITES)
def test_xla_bf16_eval_site_rounds_om_as_reference(site_inputs, path):
    x = site_inputs[path]
    want_y, want_off, want_mask = _reference_site(path, x)
    got_y, got_off, got_mask = _port_site(path, x)
    # the site's output: the same offsets and mask leave only the order of
    # the f32 sums, so a few outputs sit one bf16 step apart after BN
    err = np.abs(got_y - want_y).max() / np.abs(want_y).max()
    assert err < 1e-2, (path, err)
    assert got_off is not None, (
        f"{path}: the eval site under xla did not take the explicit "
        "offset/mask path (the reference never runs the om-fused kernel "
        f"there); site output rel err {err:.3e}")
    # the offsets and the mask: equal, except where the two convs, summing
    # in a different order, round to neighbouring bf16 values; the bias add
    # then rounds again, so such an offset may sit one step of the conv's
    # output (|conv| <= |om| + |bias|) plus one step of om apart
    omb = _node(jax_variables()["params"], path)["DCN_0"]["conv_offset_mask"]
    omb = np.asarray(jnp.asarray(omb["bias"], jnp.bfloat16).astype(
        jnp.float32))
    assert got_off.shape == want_off.shape and got_mask.shape == want_mask.shape
    step = _bf16_step(np.abs(want_off) + np.abs(omb[:18])) + _bf16_step(want_off)
    assert np.all(np.abs(got_off - want_off) <= step), path
    assert np.mean(got_off == want_off) > 0.999, (path, np.mean(got_off == want_off))
    assert np.all(np.abs(got_mask - want_mask) <= _bf16_step(want_mask)), path
    assert np.mean(got_mask == want_mask) > 0.999, path


def test_pallas_full_sites_stay_fused_at_512():
    """At 512x512 all 7 site shapes are inside the reference's om-fused
    envelope, so the port's eval site keeps K1 there (and no site is
    fused under ``xla``)."""
    for cin, cout, hw in SITES_512:
        assert dp.fused_om_supported(hw, hw, cin, cout)
        assert dc.site_om_fused(hw, hw, cin, cout, "pallas_full")
        assert dc.site_om_fused(hw, hw, cin, cout, "pallas")
        assert not dc.site_om_fused(hw, hw, cin, cout, "xla")
    calls = {"fused": 0, "explicit": 0}

    def fused(x, *a, **k):
        calls["fused"] += 1
        return x.new_zeros(*x.shape[:3], a[2].shape[-1])

    def explicit(x, *a, **k):
        calls["explicit"] += 1
        return x.new_zeros(*x.shape[:3], a[2].shape[-1])

    with mock.patch.object(tdla, "dcn_v2_fused", fused), \
            mock.patch.object(tdla, "dcn_v2", explicit), torch.no_grad():
        for cin, cout, hw in SITES_512:
            site = tdla.DCN(cin, cout, "pallas_full").eval()
            site(torch.zeros(1, cin, hw, hw))
    assert calls == {"fused": len(SITES_512), "explicit": 0}


def _port_outputs(dtype: str, x: np.ndarray) -> dict:
    """Each module's output of the port's dla_34 at 128x128 (xla policy) in
    ``dtype``, NHWC float32 numpy, by dotted module path, in call order."""
    cfg = torch_cfg(128, "xla", compute_dtype=dtype)
    model = torch_model(cfg)
    if dtype == "bfloat16":
        model = to_compute_dtype(model, torch.bfloat16)
    got = {}

    def hook(m, a, out, name):
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            got.setdefault(name, out.detach().permute(0, 2, 3, 1).float().numpy())

    for name, m in model.named_modules():
        if name:
            m.register_forward_hook(lambda m, a, o, n=name: hook(m, a, o, n))
    with torch.no_grad():
        model(torch.from_numpy(x))
    return got


def _reference_outputs(dtype: str, x: np.ndarray) -> dict:
    """The same of the reference's jitted model (flax's captured
    intermediates), by the same dotted paths."""
    from centerpose_tpu.models.factory import create_model as j_create
    from _torch_port import jax_cfg

    model = j_create(jax_cfg(128, "xla", compute_dtype=dtype))
    _, state = jax.jit(lambda v, a: model.apply(
        v, a, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(jax_variables(), jnp.asarray(x))
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                if len(v) == 1 and getattr(v[0], "ndim", 0) == 4:
                    out[".".join(path)] = np.asarray(v[0].astype(jnp.float32))
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(state["intermediates"], [])
    return out


def _feed_bn_unrounded(stack) -> None:
    """Patch the port (on the CPU) so that every conv and DCN output reaches
    its BatchNorm unrounded, as the reference's compiled graph does: XLA
    drops the round trip through bf16 where BatchNorm promotes its input
    to f32 (the convs run in f32 on bf16 values, as XLA runs them on the
    CPU); BatchNorm's output is rounded to bf16."""
    import torch.nn.functional as F

    from centerpose_tpu_torch.models import common
    from centerpose_tpu_torch.ops.dcn import dcn_v2 as plain

    def bn_f32(bn, y, dtype):
        return F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps).to(dtype)

    def conv_bn(self, x):
        c = self.Conv_0
        y = F.conv2d(x.float(), c.weight.float(), None, c.stride, c.padding)
        y = bn_f32(self.BatchNorm_0, y, x.dtype)
        return torch.relu(y) if self.relu else y

    def deform_conv(self, x):
        return torch.relu(bn_f32(self.BatchNorm_0, self.DCN_0(x), x.dtype))

    stack.enter_context(mock.patch.object(common.ConvBN, "forward", conv_bn))
    stack.enter_context(mock.patch.object(tdla.DeformConv, "forward",
                                          deform_conv))
    stack.enter_context(mock.patch.object(
        tdla, "dcn_v2", lambda *a: plain(*a, out_dtype=torch.float32)))


def per_layer_report(unrounded: bool = False) -> None:
    """Where the port's bf16 model leaves the reference's: for every module
    output both packages name alike (trunk levels, DCN sites, IDA nodes,
    heads), max |port - reference| / max |reference| in bf16 and the share
    of bit-equal values, beside each package's own bf16-vs-f32 distance, on
    one seeded 128x128 input.  ``unrounded``: with ``_feed_bn_unrounded``."""
    import contextlib

    x = np.random.default_rng(11).normal(size=(1, 128, 128, 3)).astype(
        np.float32)
    pf = _port_outputs("float32", x)
    with contextlib.ExitStack() as stack:
        if unrounded:
            _feed_bn_unrounded(stack)
        pb = _port_outputs("bfloat16", x)
    rb, rf = _reference_outputs("bfloat16", x), _reference_outputs("float32", x)

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    print(f"{'module':40s} {'port-ref bf16':>13s} {'ref bf16-f32':>13s} "
          f"{'port bf16-f32':>13s} {'equal':>6s}")
    for name in pb:
        if name in rb and pb[name].shape == rb[name].shape:
            print(f"{name:40s} {rel(pb[name], rb[name]):13.3e} "
                  f"{rel(rb[name], rf[name]):13.3e} "
                  f"{rel(pb[name], pf[name]):13.3e} "
                  f"{np.mean(pb[name] == rb[name]):6.3f}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_dla_site.py [--unrounded]
    jax.config.update("jax_platforms", "cpu")
    import sys

    per_layer_report("--unrounded" in sys.argv)
