"""The bf16 training step against the reference's compiled train step:
where the reference rounds (``_torch_port.train_step_reading``: the
forward in train mode and ``jax.grad`` of the loss, jitted, read from its
compiled HLO), each conv -> BatchNorm hand-off of ``models/common.conv_bn``
and the heads in bf16 train mode against the reference modules' jitted
``value_and_grad``, and one whole dla_34 step at 128x128."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerpose_tpu_torch.models import common

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import (CONV_BN_KINDS, FAST_COMPILE,
                         check_dla34_train_reading, conv_bn_case,
                         port_state_dict, rel_err, seeded, shapes, torch_cfg)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def test_reference_train_step_rounds_where_the_port_does():
    """dla_34 at 128x128 on the snapshot under ``dcn_impl`` xla (pallas_full:
    ``tests/test_torch_train_graph_pallas.py``): the compiled bf16 train
    step feeds 39 of its 55 BatchNorms an f32 conv result and the 16 DCN
    sites a rounded value, rounds both operands of every conv and dot
    outside the DCN sites, backward convs included, and leaves the heads'
    output bias sum in f32."""
    check_dla34_train_reading("xla")


def _reference_train(jmod, variables, x, ct):
    """The reference module in train mode, jitted: (output, batch
    statistics after it, gradient of sum(output * ct) by input, by params)."""

    def f(params, xb):
        y, mut = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xb, train=True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * ct), (y, mut["batch_stats"])

    (_, (y, bs)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"], x)
    return y, bs, gx, gp


@pytest.mark.parametrize("kind", CONV_BN_KINDS)
def test_conv_bn_bf16_train_bit_equal_to_reference(kind):
    """One ``ConvBN`` / ``DeconvBN`` in bf16 train mode (float32 master
    weights cast at use) against the reference module's jitted
    ``value_and_grad`` on the same weights, input and cotangent: the
    output, the input's and the weight's gradients bit-equal (at least 99%
    of the values: the f32 sums of each conv run in another order, which
    moves a value across a bf16 rounding boundary now and then), the
    batch statistics to f32 rounding (1e-6); the weight's gradient is an
    f32 sum on both sides (1e-4 of its largest element).  The train mode
    before the repair, a bf16 conv that rounds its result before
    BatchNorm and a bf16 weight gradient, fails these."""
    jmod, port, cin = conv_bn_case(kind)
    r = np.random.default_rng(3)
    x = _bf16(r.normal(size=(2, 12, 20, cin)))
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = seeded(shapes(jmod, xb), 4)
    out_shape = jax.eval_shape(lambda: jmod.apply(variables, xb)).shape
    ct = _bf16(r.normal(size=out_shape))
    y, bs, gx, gp = _reference_train(jmod, variables, xb, ct)

    port.load_state_dict({**port_state_dict(variables),
                          "BatchNorm_0.num_batches_tracked":
                          torch.zeros((), dtype=torch.long)})
    port = common.set_compute_dtype(port.train(), torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    xt.requires_grad_()
    got = port(xt)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()

    def equal(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        return np.mean(a == b)

    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()  # noqa
    assert equal(nhwc(got), y.astype(jnp.float32)) >= 0.99
    assert equal(nhwc(xt.grad), gx.astype(jnp.float32)) >= 0.99
    conv = port.ConvTranspose_0 if kind == "deconv" else port.Conv_0
    want_gw = port_state_dict({"params": gp, "batch_stats": {}})
    name = "ConvTranspose_0.weight" if kind == "deconv" else "Conv_0.weight"
    gw_err = rel_err(conv.weight.grad.numpy(), want_gw[name].numpy())
    assert gw_err <= 1e-4, gw_err
    bn = port.BatchNorm_0
    for stat, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        want = np.asarray(bs["BatchNorm_0"][stat])
        err = np.abs(buf.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-6, (stat, err)


def test_heads_train_round_as_reference_compiled():
    """The bf16 heads in train mode against the reference's jitted
    ``value_and_grad``: the outputs and the input's gradient bit-equal (at
    least 99% of the values, as for ``conv_bn``): each conv's result
    rounded, the hidden bias sum rounded, the output bias sum in f32.  A
    conv that adds its bias before one rounding, with a rounded output,
    leaves far fewer equal."""
    from centerpose_tpu.models.common import HeadStack as JHeads
    from centerpose_tpu_torch.models.common import HeadStack

    heads = {"hm": 1, "wh": 2, "hps": 34}
    r = np.random.default_rng(0)
    x = _bf16(r.normal(size=(2, 16, 16, 32)))
    jm = JHeads(heads, 64, dtype=jnp.bfloat16)
    v = seeded(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((2, 16, 16, 32)))), 5)
    cts = {n: _bf16(r.normal(size=(2, 16, 16, c))) for n, c in heads.items()}

    def f(xb):
        out = jm.apply(v, xb)
        return sum(jnp.sum(out[n] * cts[n]) for n in heads), out

    (_, want), gx = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x, jnp.bfloat16))
    port = HeadStack(32, heads, 64)
    port.load_state_dict(port_state_dict({"params": v["params"],
                                          "batch_stats": {}}))
    port = common.set_compute_dtype(port.train(), torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    xt.requires_grad_()
    got = port(xt)
    sum((got[n] * torch.from_numpy(cts[n])).sum() for n in heads).backward()
    for n in heads:
        assert got[n].dtype == torch.float32
        assert np.mean(got[n].detach().numpy() == np.asarray(want[n])) >= 0.99
    g = xt.grad.float().permute(0, 2, 3, 1).numpy()
    assert np.mean(g == np.asarray(gx.astype(jnp.float32))) >= 0.99


def _flat(tree, group, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if hasattr(v, "items"):
            out.update(_flat(v, group, path))
        else:
            out[f"{group}:{path}"] = np.asarray(v)
    return out


def _dla34_step_gaps():
    """(loss relative error, BatchNorm statistics' relative errors sorted)
    of one bf16 train step of dla_34 at 128x128 (``dcn_impl`` xla, the
    snapshot, batch 2, seeded input and targets), the ``Trainer``'s
    against the reference's jitted step."""
    import centerpose_tpu.losses as jlosses
    from centerpose_tpu.models.factory import create_model as j_create
    from centerpose_tpu_torch.train.trainer import Trainer
    from centerpose_tpu_torch.weights import npz_arrays, state_dict_from_npz

    from _torch_port import NPZ, jax_cfg, jax_variables, loss_targets

    jcfg = jax_cfg(128, "xla", compute_dtype="bfloat16")
    model = j_create(jcfg)
    var = jax_variables()
    x = np.random.default_rng(7).normal(size=(2, 128, 128, 3)).astype(
        np.float32)
    targets = loss_targets(jcfg)

    def loss_fn(params, bs, a, t):
        out, mut = model.apply({"params": params, "batch_stats": bs}, a,
                               train=True, mutable=["batch_stats"])
        return jlosses.multi_pose_loss(out, t, jcfg)[0], mut["batch_stats"]

    args = (var["params"], var["batch_stats"], jnp.asarray(x), targets)
    (loss, bs), _ = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        *args).compile(compiler_options=FAST_COMPILE)(*args)
    trainer = Trainer(torch_cfg(128, "xla", compute_dtype="bfloat16"),
                      state_dict_from_npz(NPZ), device="cpu")
    stats = trainer.backward({"input": x, **targets})
    want = _flat(bs, "batch_stats")
    got = npz_arrays(trainer.model.state_dict(), want)
    return (abs(float(stats["loss"]) - float(loss)) / float(loss),
            sorted(rel_err(got[k], v) for k, v in want.items()))


def test_dla34_bf16_train_step_near_reference():
    """One bf16 train step of dla_34 at 128x128 (``_dla34_step_gaps``):
    with the conv -> BatchNorm hand-off repaired the BatchNorm statistics
    lie at most 1.0e-3 (median 5.8e-5) of their largest element from the
    reference's, against 2.7e-3 (1.7e-4) with the conv rounded first; the
    loss 2.1e-4 against 8.3e-5: both graphs still round differently
    around the residual sums and the DCN sites, which the loss feels
    through the whole depth (``python tests/test_torch_train_graph.py``
    prints these)."""
    loss, errs = _dla34_step_gaps()
    assert loss <= 3e-3
    assert len(errs) == 110
    assert errs[-1] <= 1.6e-3 and errs[len(errs) // 2] <= 1e-4, (
        errs[-1], errs[len(errs) // 2])


if __name__ == "__main__":
    # From the repository root: PYTHONPATH=. python
    # tests/test_torch_train_graph.py (in a parent's checkout too)
    jax.config.update("jax_platforms", "cpu")
    loss, errs = _dla34_step_gaps()
    print(f"dla_34 128x128 bf16 step, port against reference: loss "
          f"{loss:.3e}; BatchNorm statistics max {errs[-1]:.3e}, median "
          f"{errs[len(errs) // 2]:.3e} ({len(errs)} tensors)")
