"""The reference's ``dcn_impl: conv`` ablation (``models/dla.py: DCN``): a
plain 3x3 conv with the DCN's weight and bias at every site, no
offset/mask parameters.  Where its compiled bf16 graph rounds (the reading
of ``_torch_port.bn_inputs`` and ``train_step_reading`` under ``conv``),
one site bit-equal to the reference module, dla_34 at 64x64 against the
reference in float32 and bfloat16 eval, and one float32 training step
against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import centerpose_tpu.models.dla as jdla
from centerpose_tpu.models.factory import create_model as j_create
from centerpose_tpu_torch.models.common import (to_channels_last,
                                                to_compute_dtype)
from centerpose_tpu_torch.models.dla import DCN
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.weights import load_state_dict, state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import (FAST_COMPILE, NPZ, _forward, _parse_hlo, _source,
                         jax_cfg, jax_variables, rel_err, torch_cfg)
from test_torch_train import _step64

HEADS = ("hm", "wh", "hps", "reg", "hm_hp", "hp_offset")
SITE = "ida_up.node_1"  # 64 -> 64 at 16x16 (the flagship's 64 -> 64 @128)


def _conv_sd() -> dict:
    """The snapshot without the offset/mask parameters the ablation lacks
    (the reference's loader ignores them)."""
    return {k: v for k, v in state_dict_from_npz(NPZ).items()
            if "conv_offset_mask" not in k}


def _port_model(dtype: str = "float32"):
    model = create_model(torch_cfg(64, "conv", compute_dtype=dtype))
    load_state_dict(model, _conv_sd())
    model = to_channels_last(model).eval()
    return to_compute_dtype(model, torch.bfloat16) if dtype == "bfloat16" \
        else model


def _locate(hlo, comp: str, name: str) -> tuple:
    """(computation, instruction) whose value ``name`` carries, as
    ``_torch_port._source`` follows it."""
    comps, callers, roots = hlo
    i = comps[comp][name]
    if i["op"] == "parameter" and comp in callers:
        caller, inst = callers[comp]
        return _locate(hlo, caller,
                       comps[caller][inst]["operands"][int(i["args"])])
    if i["op"] == "fusion" and i["calls"] in roots:
        return _locate(hlo, i["calls"], roots[i["calls"]])
    if i["op"] in ("bitcast", "copy", "transpose", "reshape") or (
            i["op"] == "convert" and i["dt"] == "f32"):
        return _locate(hlo, comp, i["operands"][0])
    return comp, name


def _site_feeds(hlo, train: bool) -> dict:
    """{DCN scope: (what its BatchNorm reads, the sources of that value's
    operands, and where that is a convolution, of the conv's operands)}."""
    out = {}
    for comp, insts in hlo[0].items():
        for i in insts.values():
            if not (i["op"] == "subtract" and _forward(i["opname"], train)
                    and i["opname"].endswith("BatchNorm_0/sub")):
                continue
            scope = i["opname"].split("/", 2)[2][:-len("/BatchNorm_0/sub")]
            if not scope.endswith(("proj_1", "proj_2", "proj_3", "node_1",
                                   "node_2", "node_3")) or scope in out:
                continue
            c, n = _locate(hlo, comp, i["operands"][0])
            add = hlo[0][c][n]
            parts = []
            for o in add["operands"]:
                oc, on = _locate(hlo, c, o)
                op = hlo[0][oc][on]
                ops = tuple(_source(hlo, oc, x) for x in op["operands"][:2])
                parts.append((op["op"], op["dt"],
                              ops if op["op"] == "convolution" else ()))
            out[scope] = ((add["op"], add["dt"]), sorted(parts))
    return out


def test_reference_conv_sites_round_as_the_port():
    """Under ``conv`` the reference's compiled bf16 eval graph feeds each
    site's BatchNorm the f32 sum of an unrounded f32 convolution (of two
    bf16-rounded operands) and the f32 bias: XLA drops the conv's rounding
    as at a ``ConvBN``, which the port's ``DCN._plain_conv`` follows
    (``_ConvF32``); no site takes a channel-second layout."""
    model = j_create(jax_cfg(64, "conv", compute_dtype="bfloat16"))
    text = jax.jit(lambda v, a: model.apply(v, a, train=False)).lower(
        jax_variables(), jnp.zeros((1, 64, 64, 3))).compile().as_text()
    feeds = _site_feeds(_parse_hlo(text), False)
    assert len(feeds) == 16, sorted(feeds)
    rounded = ("convert", "bf16")
    for scope, (sum_, parts) in feeds.items():
        assert sum_ == ("add", "f32"), (scope, sum_)
        assert parts == [("broadcast", "f32", ()),
                         ("convolution", "f32", (rounded, rounded))], (
            scope, parts)


def test_conv_train_step_reading():
    """The reference's compiled bf16 train step under ``conv``: the
    forward as in eval, and every convolution of the DCN sites, forward
    and backward, reads two bf16-rounded operands (the cotangent is
    rounded before the backward convs), as ``_ConvF32``'s backward does."""
    import centerpose_tpu.losses as jlosses
    from _torch_port import loss_targets

    cfg = jax_cfg(64, "conv", compute_dtype="bfloat16")
    model = j_create(cfg)
    v = jax_variables()

    def loss_fn(params, bs, x, targets):
        out, mut = model.apply({"params": params, "batch_stats": bs}, x,
                               train=True, mutable=["batch_stats"])
        return jlosses.multi_pose_loss(out, targets, cfg)[0], mut

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    text = step.lower(v["params"], v["batch_stats"], jnp.zeros((2, 64, 64, 3)),
                      loss_targets(cfg)).compile(
        compiler_options=FAST_COMPILE).as_text()
    hlo = _parse_hlo(text)
    feeds = _site_feeds(hlo, True)
    assert len(feeds) == 16
    for scope, (sum_, parts) in feeds.items():
        assert sum_ == ("add", "f32") and parts[1][:2] == (
            "convolution", "f32"), (scope, sum_, parts)
    rounded = ("convert", "bf16")
    n = {"fwd": 0, "bwd": 0}
    for comp, insts in hlo[0].items():
        for i in insts.values():
            if i["op"] == "convolution" and "DCN_0" in i["opname"]:
                srcs = tuple(_source(hlo, comp, o) for o in i["operands"][:2])
                n["fwd" if _forward(i["opname"], True) else "bwd"] += 1
                assert srcs == (rounded, rounded), (i["opname"], srcs)
    assert n["fwd"] == 16 and n["bwd"] >= 16, n


def test_conv_site_bf16_bit_equal_to_reference():
    """One site's DeformConv in bf16 eval against the jitted reference
    module on the snapshot's weights, as ``ConvBN`` is held: bit-equal
    outputs but for the order of the f32 sums (>= 99% of the values)."""
    v = jax_variables()
    node = {g: v[g] for g in v}
    for part in SITE.split("."):
        node = {g: node[g][part] for g in node}
    node["params"]["DCN_0"].pop("conv_offset_mask")
    jmod = jdla.DeformConv(64, dcn_impl="conv", dtype=jnp.bfloat16)
    x = np.random.default_rng(7).normal(size=(2, 16, 16, 64))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a))(
        node, xb).astype(jnp.float32))
    site = _port_model("bfloat16").get_submodule(SITE)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = site(xt.contiguous(memory_format=torch.channels_last))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert np.mean(got == want) >= 0.99, np.mean(got == want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dla34_conv_heads_match_reference(dtype, monkeypatch):
    x = np.random.default_rng(11).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    model = j_create(jax_cfg(64, "conv", compute_dtype=dtype))
    want = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        jax_variables(), jnp.asarray(x))
    port = _port_model(dtype)
    assert not any(hasattr(m, "conv_offset_mask") for m in port.modules()
                   if isinstance(m, DCN))
    # the ablation reaches no site policy and no DCN kernel
    for name in ("site_max_dy", "site_om_fused", "train_site_max_dy",
                 "dcn_v2", "dcn_v2_fused"):
        monkeypatch.setattr(f"centerpose_tpu_torch.models.dla.{name}",
                            None, raising=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    tol = 1e-4 if dtype == "float32" else 3e-2  # test_torch_model.py's
    for name in HEADS:
        assert got[name].dtype == torch.float32
        assert rel_err(got[name].numpy(), np.asarray(want[name])) < tol, name
    with pytest.raises(NotImplementedError):  # never reached for conv
        dc.site_max_dy(16, 16, 64, 64, "conv")


def test_conv_train_step_matches_jax():
    """One float32 step at 64x64 under ``conv``, held as
    ``tests/test_torch_train.py`` holds the ``xla`` one: the loss against
    the reference's, every gradient against the reference's in float64,
    and the BatchNorm statistics at 1e-5 against the reference's in
    float64 too: here the reference's own float32 statistics lie 2.1e-5
    from those (a variance over the 8 values of a 2x2 map), the port's
    1.7e-6."""
    port, ref = _step64("conv", adam=False)
    total = ref["stats"]["loss"]
    assert abs(port["stats"]["loss"] - total) <= 1e-5 * abs(total)
    for k, v in ref["stats"].items():
        assert abs(port["stats"][k] - v) <= 5e-5 * max(abs(v), 1.0), k
    assert not any("conv_offset_mask" in k for k in ref["grads64"])
    assert ref["batch_stats64"].keys() == ref["batch_stats"].keys()
    for k, v in ref["batch_stats64"].items():
        assert rel_err(port["batch_stats"][k], v) < 1e-5, k
    g_all = max(np.abs(v).max() for v in ref["grads64"].values())
    for k, want in ref["grads64"].items():
        got = port["grads"][k]
        if "['DCN_0']['bias']" in k:  # BatchNorm follows: zero up to rounding
            assert np.abs(got).max() < 1e-5 * g_all, k
            assert np.abs(want).max() < 1e-5 * g_all, k
        else:
            assert rel_err(got, want) < 1e-4, k
    trainer = port["trainer"]
    assert len(trainer.optimizer.params) == len(list(
        trainer.model.parameters()))
