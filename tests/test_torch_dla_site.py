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

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import bn_inputs, jax_variables, torch_cfg, torch_model

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
    ``dtype``, as the model hands it on (rounded to ``dtype``: a BatchNorm
    fed an f32 conv result returns f32, which its ``ConvBN`` rounds), NHWC
    float32 numpy, by dotted module path, in call order; then the model's
    float32 head outputs as ``heads.{name}``."""
    cfg = torch_cfg(128, "xla", compute_dtype=dtype)
    model = torch_model(cfg)
    if dtype == "bfloat16":
        model = to_compute_dtype(model, torch.bfloat16)
    dt = getattr(torch, dtype)
    got = {}

    def hook(m, a, out, name):
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            got.setdefault(name, out.detach().to(dt).permute(
                0, 2, 3, 1).float().numpy())

    for name, m in model.named_modules():
        if name:
            m.register_forward_hook(lambda m, a, o, n=name: hook(m, a, o, n))
    with torch.no_grad():
        heads = model(torch.from_numpy(x))
    got.update({f"heads.{k}": v.numpy() for k, v in heads.items()})
    return got


def _reference_outputs(dtype: str, x: np.ndarray) -> dict:
    """The same of the reference's jitted model (flax's captured
    intermediates), by the same dotted paths; the head outputs of the
    jitted model without the capture (which materialises intermediates)."""
    from centerpose_tpu.models.factory import create_model as j_create
    from _torch_port import jax_cfg

    model = j_create(jax_cfg(128, "xla", compute_dtype=dtype))
    heads = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        jax_variables(), jnp.asarray(x))
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
    out.update({f"heads.{k}": np.asarray(v) for k, v in heads.items()})
    return out


def _seeded_input() -> np.ndarray:
    return np.random.default_rng(11).normal(size=(1, 128, 128, 3)).astype(
        np.float32)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_reference_feeds_batchnorm_f32_from_convs_only():
    """The premise of ``models/common.conv_bn``: in the reference's compiled
    bf16 eval graph every conv's f32 result reaches its BatchNorm unrounded
    (XLA drops the bf16 round trip), while each DCN output is rounded to
    bf16 first (its explicit cast survives)."""
    feeds = bn_inputs("xla")
    dcn = {s for s in feeds if "_up/" in s}
    assert len(feeds) == 53 and len(dcn) == 16, sorted(feeds)
    for scope, (op, dt) in feeds.items():
        want = ("convert", "bf16") if scope in dcn else (op, "f32")
        assert (op, dt) == want and op in ("convert", "convolution", "dot"), (
            scope, op, dt)


def test_xla_bf16_batchnorm_gets_the_conv_f32_result():
    """The port against the reference at 128x128 under xla bf16:
    the first layer's BatchNorm output bit-equal (a bf16 conv that rounds
    its result before BatchNorm gives 71.9%), and the ``hm`` head within
    6e-3 of it, half the reference's own bf16-to-f32 distance (1.47e-2
    with that rounding)."""
    x = _seeded_input()
    pb, rb = _port_outputs("bfloat16", x), _reference_outputs("bfloat16", x)
    first = "base.base_layer.BatchNorm_0"
    assert np.mean(pb[first] == rb[first]) >= 0.99, np.mean(pb[first] == rb[first])
    assert _rel(pb["heads.hm"], rb["heads.hm"]) <= 6e-3, _rel(
        pb["heads.hm"], rb["heads.hm"])


@pytest.mark.parametrize("factor", [2, 4])
def test_ida_upsample_and_sum_in_f32_as_reference(factor):
    """The reference's bilinear weights are numpy f32 scalars, so its bf16
    upsample and the sum with the shallower layer run in f32 and are
    rounded once, where the node's DCN casts its input (type promotion: on
    every backend and in training too).  The port's IDA node input against
    the jitted reference ops, bit for bit (rounding the upsample and then
    the sum gives about 76%)."""
    import centerpose_tpu_torch.models.common as tcommon

    rng = np.random.default_rng(factor)
    p = jnp.asarray(rng.normal(size=(1, 8, 8, 16)), jnp.bfloat16)
    layer = jnp.asarray(rng.normal(size=(1, 8 * factor, 8 * factor, 16)),
                        jnp.bfloat16)
    want = jax.jit(lambda a, b: (jdla.bilinear_upsample(a, factor) + b)
                   .astype(jnp.bfloat16))(p, layer)
    ida = tdla.IDAUp(16, [16, 16], [1, factor])
    ida.proj_1, ida.node_1 = torch.nn.Identity(), torch.nn.Identity()
    ida = tcommon.to_compute_dtype(ida.eval(), torch.bfloat16)

    def nchw(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16).permute(0, 3, 1, 2)

    with torch.no_grad():
        got = ida([nchw(layer), nchw(p)], 0, 2)[1]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tf32_only_around_bf16_convs_on_cuda(dtype):
    """``tf32_convs`` lets cuDNN use TF32 only for bf16 values on a CUDA
    device (exact there), never for a float32 model's convs or the IDA
    upsample, whose rows keep the caller's setting (off in the tools);
    the setting is restored on leaving."""
    from types import SimpleNamespace

    from centerpose_tpu_torch.models.common import tf32_convs

    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        for device in ("cuda", "cpu"):
            x = SimpleNamespace(device=torch.device(device), dtype=dtype)
            with tf32_convs(x):
                on = torch.backends.cudnn.allow_tf32
            assert on == (device == "cuda" and dtype == torch.bfloat16)
            assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_heads_round_as_reference_compiled():
    """bf16 heads in eval mode: the jitted reference rounds each conv's
    result, then its bias sum inside the head, and leaves the output
    conv's bias sum in f32 (the cast to f32 drops that rounding).  The
    port's heads bit-equal (a conv that adds its bias before one rounding,
    and a rounded output, give 0-27%)."""
    import tempfile

    from centerpose_tpu.models.common import HeadStack as JHeads
    from centerpose_tpu.train.checkpoints import save_params_npz
    from centerpose_tpu_torch.models.common import HeadStack
    from centerpose_tpu_torch.weights import state_dict_from_npz

    heads = {"hm": 1, "wh": 2, "hps": 34}
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 32))
    jm = JHeads(heads, 64, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 32)))
    v = jax.tree_util.tree_map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), a.shape), v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x, jnp.bfloat16))
    with tempfile.TemporaryDirectory() as d:
        save_params_npz({"params": v["params"], "batch_stats": {}},
                        f"{d}/heads.npz")
        sd = state_dict_from_npz(f"{d}/heads.npz")
    port = HeadStack(32, heads, 64)
    port.load_state_dict(sd)
    port = to_compute_dtype(port.eval(), torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    for name in heads:
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def per_layer_report() -> None:
    """Where the port's bf16 model leaves the reference's: for every module
    output both packages name alike (trunk levels, DCN sites, IDA nodes,
    heads), max |port - reference| / max |reference| in bf16 and the share
    of bit-equal values, beside each package's own bf16-vs-f32 distance, on
    one seeded 128x128 input; then what feeds each BatchNorm of the
    reference's compiled graph under xla and pallas_full at 128x128, and
    under xla at 512x512 (``bn_inputs``)."""
    x = _seeded_input()
    pf, pb = _port_outputs("float32", x), _port_outputs("bfloat16", x)
    rb, rf = _reference_outputs("bfloat16", x), _reference_outputs("float32", x)
    print(f"{'module':40s} {'port-ref bf16':>13s} {'ref bf16-f32':>13s} "
          f"{'port bf16-f32':>13s} {'equal':>6s}")
    for name in pb:
        if name in rb and pb[name].shape == rb[name].shape:
            print(f"{name:40s} {_rel(pb[name], rb[name]):13.3e} "
                  f"{_rel(rb[name], rf[name]):13.3e} "
                  f"{_rel(pb[name], pf[name]):13.3e} "
                  f"{np.mean(pb[name] == rb[name]):6.3f}")
    for impl, res in (("xla", 128), ("pallas_full", 128), ("xla", 512)):
        feeds = bn_inputs(impl, res)
        rounded = sum(src == ("convert", "bf16") for src in feeds.values())
        print(f"BatchNorm inputs under {impl} at {res}x{res}: {len(feeds)} "
              f"BatchNorms, {rounded} fed a bf16-rounded value")
        for scope, src in sorted(feeds.items()):
            print(f"  {scope:40s} {src[0]} {src[1]}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_dla_site.py
    jax.config.update("jax_platforms", "cpu")
    per_layer_report()
