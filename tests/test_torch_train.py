"""Port parity of the training step: the losses, the compact-wire unpack,
the optimizer and its schedule against optax, and one whole dla_34 train
step at 64x64 from the committed snapshot against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import centerpose_tpu.losses as jlosses
import centerpose_tpu.native as jnative
from centerpose_tpu.config import update_config as jupdate
from centerpose_tpu.data.encode import encode_example as j_encode
from centerpose_tpu.models.factory import create_model as j_create_model
from centerpose_tpu.train.trainer import make_optimizer as j_make_optimizer
from centerpose_tpu.train.trainer import unpack_batch as j_unpack
from centerpose_tpu_torch import losses
from centerpose_tpu_torch.config import update_config
from centerpose_tpu_torch.data.encode import stack_batch
from centerpose_tpu_torch.data.synthetic import make_person
from centerpose_tpu_torch.train.trainer import (Optimizer, Trainer,
                                                batch_to_device, unpack_batch)
from centerpose_tpu_torch.weights import npz_arrays, state_dict_from_npz

from _torch_port import NPZ, jax_cfg, jax_variables, rel_err, torch_cfg

OV = {"train": {"wire": "compact"}, "dataset": {"max_objs": 8}}


def _targets(seed, b=2, h=16, w=16, j=17, k=8):
    r = np.random.default_rng(seed)
    hm = r.uniform(0, 0.99, (b, h, w, 1)).astype(np.float32)
    hm_hp = r.uniform(0, 0.99, (b, h, w, j)).astype(np.float32)
    hm[0, 3, 4, 0] = hm[1, 7, 7, 0] = 1.0
    hm_hp[0, 2, 2, 5] = 1.0
    return {
        "hm": hm, "hm_hp": hm_hp,
        "wh": r.uniform(1, 9, (b, k, 2)).astype(np.float32),
        "reg": r.uniform(0, 1, (b, k, 2)).astype(np.float32),
        "hps": r.normal(size=(b, k, 2 * j)).astype(np.float32),
        "ind": r.integers(0, h * w, (b, k)).astype(np.int32),
        "reg_mask": (r.random((b, k)) > 0.4).astype(np.float32),
        "hps_mask": (r.random((b, k, 2 * j)) > 0.3).astype(np.float32),
        "hp_offset": r.uniform(0, 1, (b, k * j, 2)).astype(np.float32),
        "hp_ind": r.integers(0, h * w, (b, k * j)).astype(np.int32),
        "hp_mask": (r.random((b, k * j)) > 0.5).astype(np.float32),
        "dense_hps": r.normal(size=(b, h, w, 2 * j)).astype(np.float32),
        "dense_hps_mask": (r.random((b, h, w, 2 * j)) > 0.7).astype(np.float32),
    }


def _outputs(seed, b=2, h=16, w=16):
    r = np.random.default_rng(seed)
    chans = {"hm": 1, "wh": 2, "hps": 34, "reg": 2, "hm_hp": 17,
             "hp_offset": 2}
    return {n: (r.normal(size=(b, h, w, c)) * 3).astype(np.float32)
            for n, c in chans.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("dense_hp", [False, True])
def test_losses_match_jax(dense_hp):
    out, tgt = _outputs(1), _targets(2)
    ov = {"loss": {"dense_hp": dense_hp}}
    jcfg = jupdate(jax_cfg(64), ov)
    tcfg = update_config(torch_cfg(64), ov)
    want_total, want = jlosses.multi_pose_loss(_j(out), _j(tgt), jcfg)
    got_total, got = losses.multi_pose_loss(_t(out), _t(tgt), tcfg)
    assert got.keys() == want.keys()
    for k in want:  # f32 reductions of the same terms: summation order only
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(
            1.0, abs(float(want[k]))), k
    assert abs(float(got_total) - float(want_total)) <= 1e-5 * float(want_total)


def test_focal_loss_branches_match_jax():
    r = np.random.default_rng(3)
    pred = r.uniform(1e-4, 1 - 1e-4, (2, 8, 8, 3)).astype(np.float32)
    gt = r.uniform(0, 0.9, (2, 8, 8, 3)).astype(np.float32)  # no peak
    for g in (gt, np.where(gt > 0.8, 1.0, gt).astype(np.float32)):
        want = float(jlosses.focal_loss(jnp.asarray(pred), jnp.asarray(g)))
        got = float(losses.focal_loss(torch.from_numpy(pred),
                                      torch.from_numpy(g)))
        assert abs(got - want) <= 1e-6 * abs(want)


def test_unpack_batch_matches_jax():
    r = np.random.default_rng(4)
    batch = {"input": r.integers(0, 256, (2, 16, 16, 3), np.uint8),
             "aug": np.stack([
                 np.array([1.2, -0.1, 0.3, 0.01, -0.02, 0.03], np.float32),
                 np.array([1, 0, 0, 0, 0, 0], np.float32)]),
             "hm": r.random((2, 4, 4, 1)).astype(np.float16),
             "ind": r.integers(0, 16, (2, 8)).astype(np.int32)}
    cfg_j, cfg_t = jupdate(jax_cfg(16), OV), update_config(torch_cfg(16), OV)
    want = j_unpack(_j(batch), cfg_j)
    got = unpack_batch(batch_to_device(batch, torch.device("cpu")), cfg_t)
    assert got.keys() == want.keys() == {"input", "hm", "ind"}
    np.testing.assert_allclose(got["input"].numpy(), np.asarray(want["input"]),
                               rtol=0, atol=1e-5)
    assert got["hm"].dtype == torch.float32
    np.testing.assert_array_equal(got["hm"].numpy(), np.asarray(want["hm"]))
    np.testing.assert_array_equal(got["ind"].numpy(), np.asarray(want["ind"]))


@pytest.mark.parametrize("name,accum", [("adam", 1), ("adam", 3), ("sgd", 1),
                                        ("sgd", 2)])
def test_optimizer_and_schedule_match_optax(name, accum):
    """The same gradients through optax and through the port's Optimizer:
    lr x0.1 at updates 4 and 6 (lr_step 2, 3 at 2 updates per epoch),
    MultiSteps accumulation over ``accum`` micro-batches."""
    ov = {"train": {"optimizer": name, "grad_accum": accum, "lr": 0.1,
                    "lr_step": (2, 3)}}
    jcfg, tcfg = jupdate(jax_cfg(64), ov), update_config(torch_cfg(64), ov)
    r = np.random.default_rng(5)
    p0 = {"a": r.normal(size=(3, 4)).astype(np.float32),
          "b": r.normal(size=(5,)).astype(np.float32)}
    tx = j_make_optimizer(jcfg, 2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = Optimizer(tp.values(), tcfg, 2)
    for step in range(8 * accum):
        g = {k: r.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():  # backward's accumulation into .grad
            gk = torch.from_numpy(g[k])
            p.grad = gk if p.grad is None else p.grad + gk
        applied = opt.step()
        assert applied == ((step + 1) % accum == 0)
        # optax computes Adam's bias correction 1 - 0.999^t in float32,
        # where 0.999 is not exact: its early steps are ~6e-6 smaller than
        # torch's (float64), up to 5e-6 over these 8 steps of lr 0.1
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-5)
    assert opt.updates == 8


def _flat(tree, group, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if hasattr(v, "items"):
            out.update(_flat(v, group, path))
        else:
            out[f"{group}:{path}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def step64():
    return _step64()


def _step64(dcn_impl: str = "xla", adam: bool = True):
    """One train step of dla_34 at 64x64, batch 2, f32, ``dcn_impl`` (xla,
    or the conv ablation, whose model has no offset/mask parameters: the
    snapshot's are left out), from the snapshot, on a compact-wire batch of
    synthetic persons, in both packages: (loss, stats, grads, params and
    batch_stats after it) each, and the reference's gradients and
    statistics in float64.  Without ``adam`` the parameters after the
    update are left out (the reference's eager optax update takes ~20 s
    here)."""
    jcfg = jupdate(jax_cfg(64, dcn_impl), OV)
    tcfg = update_config(torch_cfg(64, dcn_impl), OV)
    rng = np.random.default_rng(0)
    examples = []
    saved = jnative.available
    jnative.available = lambda: False  # the numpy encoder, as the port's
    try:
        for i in range(2):
            img = rng.integers(0, 256, (120, 160, 3), np.uint8)
            anns = [make_person(rng, 160, 120)[0] for _ in range(2)]
            examples.append(j_encode(img, anns, jcfg,
                                     np.random.default_rng(10 + i), True))
    finally:
        jnative.available = saved
    batch = stack_batch(examples)

    model = j_create_model(jcfg)
    var = jax_variables()
    sd = state_dict_from_npz(NPZ)
    if dcn_impl == "conv":
        for path in [k for k in sd if "conv_offset_mask" in k]:
            node = var["params"]
            *parts, _ = path.split(".")
            for part in parts[:-1]:
                node = node[part]
            node.pop(parts[-1], None)
            del sd[path]

    def loss_fn(params, bs, b):
        b = j_unpack(b, jcfg)
        out, mut = model.apply({"params": params, "batch_stats": bs},
                               b["input"], train=True, mutable=["batch_stats"])
        loss, stats = jlosses.multi_pose_loss(out, b, jcfg)
        return loss, (stats, mut["batch_stats"])

    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k not in "cs"}
    (_, (jstats, jbs)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(var["params"], var["batch_stats"], jbatch)

    # The same gradients with the reference's model in float64 (the heads
    # cast to f32 for the losses, as the model does): the yardstick of
    # test_train_step_grads_match_jax.
    model64 = model.clone(dtype=jnp.float64)

    def loss64(params, bs, b):
        b = j_unpack(b, jcfg)
        out, mut = model64.apply({"params": params, "batch_stats": bs},
                                 b["input"].astype(jnp.float64), train=True,
                                 mutable=["batch_stats"])
        out = {k: v.astype(jnp.float32) for k, v in out.items()}
        return jlosses.multi_pose_loss(out, b, jcfg)[0], mut["batch_stats"]

    with jax.enable_x64(True):
        var64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), var)
        jgrads64, jbs64 = jax.jit(jax.grad(loss64, has_aux=True))(
            var64["params"], var64["batch_stats"], jbatch)
        jgrads64 = _flat(jgrads64, "params")
        jbs64 = _flat(jbs64, "batch_stats")
    tx = j_make_optimizer(jcfg, 1000)
    params = {}
    if adam:
        upd, _ = tx.update(jgrads, tx.init(var["params"]), var["params"])
        params = _flat(optax.apply_updates(var["params"], upd), "params")
    jax_side = {"stats": {k: float(v) for k, v in jstats.items()},
                "grads": _flat(jgrads, "params"), "grads64": jgrads64,
                "batch_stats64": jbs64, "params": params,
                "batch_stats": _flat(jbs, "batch_stats")}

    trainer = Trainer(tcfg, sd, device="cpu")
    stats = trainer.backward(batch)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
             for n, p in trainer.model.named_parameters()}
    assert trainer.optimizer.step()  # one update, as the JAX step's
    sd = trainer.model.state_dict()
    port = {"stats": {k: float(v) for k, v in stats.items()},
            "grads": npz_arrays(grads, jax_side["grads"]),
            "params": npz_arrays(sd, jax_side["params"]),
            "batch_stats": npz_arrays(sd, jax_side["batch_stats"]),
            "trainer": trainer, "batch": batch, "lr": tcfg.train.lr}
    return port, jax_side


def test_train_step_loss_matches_jax(step64):
    port, ref = step64
    assert port["stats"].keys() == ref["stats"].keys()
    # f32, whole model: rounding only.  BatchNorm on batch statistics of
    # tiny maps (2x2 at stride 32) amplifies it to ~1e-4 in some head
    # outputs, so a single term may move by a few 1e-5; the total is held
    # to 1e-5
    total = ref["stats"]["loss"]
    assert abs(port["stats"]["loss"] - total) <= 1e-5 * abs(total)
    for k, v in ref["stats"].items():
        assert abs(port["stats"][k] - v) <= 5e-5 * max(abs(v), 1.0), k


def test_train_step_batch_stats_match_jax(step64):
    port, ref = step64
    for k, v in ref["batch_stats"].items():
        assert rel_err(port["batch_stats"][k], v) < 1e-5, k


def test_train_step_grads_match_jax(step64):
    """Every parameter's gradient, held to 1e-4 of its largest element
    against the reference's gradient computed in float64.  The float64 run
    is the yardstick because the reference's own float32 run is far from
    it here: at 64x64, batch 2 (BatchNorm on 8 values at the 2x2 maps), the
    JAX f32 gradients differ from the JAX f64 ones by up to 2.2e-2 in
    relative L2, the port's f32 gradients by at most 1.5e-5.  The DCN
    biases feed BatchNorm on batch statistics, so their gradient is zero up
    to rounding on both sides."""
    port, ref = step64
    g_all = max(np.abs(v).max() for v in ref["grads64"].values())
    for k, want in ref["grads64"].items():
        got = port["grads"][k]
        if "['DCN_0']['bias']" in k:
            assert np.abs(got).max() < 1e-5 * g_all, k
            assert np.abs(want).max() < 1e-5 * g_all, k
        else:
            assert rel_err(got, want) < 1e-4, k


def test_train_step_adam_update_matches_jax(step64):
    """Adam's first update is lr * g / (|g| + eps) with eps 1e-8, about
    lr * sign(g): the parameters agree to f32 rounding wherever the two
    gradients agree in sign and are well above eps, and elsewhere
    (gradients that are rounding noise around zero) differ by at most
    2 lr."""
    port, ref = step64
    lr = port["lr"]
    for k, want in ref["params"].items():
        got = port["params"][k]
        g_p, g_j = port["grads"][k], ref["grads"][k]
        resolved = ((np.sign(g_p) == np.sign(g_j))
                    & (np.minimum(np.abs(g_p), np.abs(g_j)) > 1e-5))
        diff = np.abs(got - want)
        assert diff[resolved].max(initial=0.0) < 1e-6, k
        assert diff.max() <= 2 * lr * (1 + 1e-3), k


def test_eval_step_leaves_the_state_alone(step64):
    port, _ = step64
    trainer = port["trainer"]
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    stats = trainer.eval_step(port["batch"])
    assert np.isfinite(float(stats["loss"]))
    assert trainer.model.training
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_eval_step_matches_jax(step64):
    """``Trainer.eval_step`` (running statistics, the inference DCN path)
    against the reference's ``make_eval_step`` loss on the snapshot."""
    port, _ = step64
    jcfg = jupdate(jax_cfg(64, "xla"), OV)
    tcfg = update_config(torch_cfg(64, "xla"), OV)
    model = j_create_model(jcfg)
    batch = port["batch"]

    def eval_fn(variables, b):
        b = j_unpack(b, jcfg)
        out = model.apply(variables, b["input"], train=False)
        return jlosses.multi_pose_loss(out, b, jcfg)[1]

    want = jax.jit(eval_fn)(jax_variables(), {
        k: jnp.asarray(v) for k, v in batch.items() if k not in "cs"})
    got = Trainer(tcfg, state_dict_from_npz(NPZ), device="cpu").eval_step(
        batch)
    for k, v in want.items():  # f32, eval-mode BatchNorm: rounding only
        assert abs(float(got[k]) - float(v)) <= 1e-5 * max(abs(float(v)),
                                                            1.0), k


def test_trainer_random_init_is_seeded_by_the_config():
    """Without snapshot weights the model's random init is drawn from
    ``cfg.train.seed`` on a forked RNG: two trainers of one config start
    equal, another seed starts elsewhere, and the process's RNG stream is
    the one it would have been without them."""
    cfg = torch_cfg(64, "xla")
    torch.manual_seed(5)
    want = torch.rand(4)
    torch.manual_seed(5)
    a = Trainer(cfg, device="cpu").model.state_dict()
    b = Trainer(cfg, device="cpu").model.state_dict()
    assert torch.equal(torch.rand(4), want)
    c = Trainer(update_config(cfg, {"train": {"seed": cfg.train.seed + 1}}),
                device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def _grad_gaps(got, want):
    """(worst relative L2 error, worst elementwise error of a tensor's max)
    of ``got`` against ``want`` over every gradient but the DCN biases'."""
    keys = [k for k in want if "['DCN_0']['bias']" not in k]
    l2 = max(np.linalg.norm(got[k] - want[k])
             / max(np.linalg.norm(want[k]), 1e-30) for k in keys)
    return l2, max(rel_err(got[k], want[k]) for k in keys)


if __name__ == "__main__":
    # The readings behind test_train_step_grads_match_jax: how far the
    # float32 steps' gradients lie from the reference's float64 ones, for
    # the reference, the port, and the port with torch's own BatchNorm
    # normalisation (F.batch_norm) in place of flax's arithmetic.
    # From the repository root: PYTHONPATH=. python tests/test_torch_train.py
    import torch.nn.functional as F

    from centerpose_tpu_torch.models import common

    jax.config.update("jax_platforms", "cpu")
    port, ref = _step64()
    g64 = ref["grads64"]
    rows = [("JAX f32", ref["grads"], g64), ("port f32", port["grads"], g64),
            ("port f32 vs JAX f32", port["grads"], ref["grads"])]

    def torch_batch_norm(self, x):
        if not self.training:
            return torch.nn.BatchNorm2d.forward(self, x)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    common.BatchNorm2d.forward = torch_batch_norm
    rows.append(("port f32, F.batch_norm", _step64()[0]["grads"], g64))
    for name, got, want in rows:
        l2, mx = _grad_gaps(got, want)
        vs = "" if " vs " in name else " vs JAX f64"
        print(f"{name}{vs}: worst L2 {l2:.3e}, worst elementwise {mx:.3e}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_flax(dtype):
    """The port's train-mode ``BatchNorm2d`` against flax's ``BatchNorm``
    (``use_running_average=False``, momentum 0.9, eps 1e-5) on one NHWC
    input and cotangent: the output, the running statistics after the
    update, and the gradients of the input, scale and bias.  float32:
    rounding only (1e-5 of each max).  bfloat16: the output and dx are
    rounded to bf16 on both sides, so they may differ by a bf16 ulp of a
    value, at most 2^-7 of it; the statistics and the parameter gradients
    stay f32 sums of f32 products of the same bf16 inputs (1e-4)."""
    import flax.linen as fnn

    from centerpose_tpu_torch.models.common import BatchNorm2d

    r = np.random.default_rng(7)
    b, h, w, c = 2, 4, 4, 16
    x = (r.normal(size=(b, h, w, c)) + 0.5).astype(np.float32)
    ct = r.normal(size=(b, h, w, c)).astype(np.float32)
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = r.normal(size=c).astype(np.float32)
    ra_mean = r.normal(size=c).astype(np.float32)
    ra_var = r.uniform(0.5, 2.0, c).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)

    def f(xj, params):
        return bn.apply({"params": params,
                         "batch_stats": {"mean": ra_mean, "var": ra_var}},
                        xj, mutable=["batch_stats"])

    xj = jnp.asarray(x, jdt)
    (yj, mut), vjp = jax.vjp(f, xj, {"scale": scale, "bias": bias})
    dxj, dpj = vjp((jnp.asarray(ct, yj.dtype),
                    jax.tree_util.tree_map(jnp.zeros_like, mut)))

    m = BatchNorm2d(c).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(ra_mean))
        m.running_var.copy_(torch.from_numpy(ra_var))
    xt = (torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
          .contiguous(memory_format=torch.channels_last).requires_grad_())
    y = m(xt)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(ct).to(tdt).permute(0, 3, 1, 2))

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert rel_err(nhwc(y), np.asarray(yj, np.float32)) < tol
    assert rel_err(nhwc(xt.grad), np.asarray(dxj, np.float32)) < tol
    tol_f32 = 1e-5 if dtype == "float32" else 1e-4
    stats = mut["batch_stats"]
    assert rel_err(m.running_mean.numpy(), stats["mean"]) < tol_f32
    assert rel_err(m.running_var.numpy(), stats["var"]) < tol_f32
    assert rel_err(m.weight.grad.numpy(), dpj["scale"]) < tol_f32
    assert rel_err(m.bias.grad.numpy(), dpj["bias"]) < tol_f32
