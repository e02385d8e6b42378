"""Data-parallel training in the port (``parallel/mesh.py``): BatchNorm
synchronised over the ranks, the loss's global normalizers, DDP at world
size 1, equal step counts on uneven shards.  Two ranks on the CPU with
gloo (``tests/_torch_dp.py``), each holding half of the global batch,
against the one-process port and the reference on the whole batch."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import centerpose_tpu.losses as jlosses
from centerpose_tpu.config import default_config as j_default
from centerpose_tpu.config import update_config as j_update
from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.data.encode import encode_example
from centerpose_tpu_torch.data.loader import DataLoader
from centerpose_tpu_torch.data.synthetic import (SyntheticPoseDataset,
                                                 make_person)
from centerpose_tpu_torch.models.common import BatchNorm2d
from centerpose_tpu_torch.parallel.mesh import init_distributed
from centerpose_tpu_torch.train.checkpoints import to_host
from centerpose_tpu_torch.train.trainer import Trainer

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_dp import bn_case, run_ranks
from _torch_port import bit_equal, rel_err

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    """Each rank's BatchNorm readings (``_torch_dp._bn``), both dtypes."""
    return run_ranks("bn", 2, tmp_path_factory.mktemp("bn"))


def _one_process_bn(dtype: str) -> dict:
    """The port's BatchNorm on the whole batch in one process."""
    x, ct, scale, bias, ra_mean, ra_var = bn_case()
    m = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        for t, v in ((m.weight, scale), (m.bias, bias),
                     (m.running_mean, ra_mean), (m.running_var, ra_var)):
            t.copy_(torch.from_numpy(v))
    tdt = getattr(torch, dtype)
    xt = (torch.from_numpy(x).to(tdt)
          .contiguous(memory_format=torch.channels_last).requires_grad_())
    y = m(xt)
    y.backward(torch.from_numpy(ct).to(tdt))
    return {"y": y.detach().float(), "gx": xt.grad.float(),
            "gw": m.weight.grad, "gb": m.bias.grad,
            "mean": m.running_mean, "var": m.running_var}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |v| (8 significand bits)."""
    v = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _input_grad_parts(x, ct, scale):
    """The two parts flax's bf16 input gradient rounds separately
    (``models/common._flax_grads``), in float64 on the whole batch: through
    ``x - mean``, and through the statistics."""
    x = x.astype(np.float64)
    ct = ct.astype(np.float64)
    axes = (0, 2, 3)
    n = x.size // x.shape[1]
    mean = x.mean(axes, keepdims=True)
    var = (x * x).mean(axes, keepdims=True) - mean * mean
    inv = 1.0 / np.sqrt(var + 1e-5)
    w = scale.astype(np.float64).reshape(1, -1, 1, 1)
    direct = ct * inv * w
    dvar = (ct * (x - mean)).sum(axes, keepdims=True) * w * -0.5 * inv ** 3
    dmean = -direct.sum(axes, keepdims=True) - dvar * 2 * mean
    return direct, dmean / n + x * dvar * 2 / n


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sync_batchnorm_matches_one_process(bn_ranks, dtype):
    """Two ranks, each with half of an [8, 16, 16, 16] batch, against the
    port's BatchNorm on the whole batch in one process: the output and the
    input gradient (the ranks' halves together), the running statistics
    (bit-equal on the two ranks), and the scale and bias gradients (each
    rank's partial sums add up to the whole batch's).  float32: rtol
    1e-5 (the global sums are the halves' sums added, another order).
    bfloat16: the output within one bf16 ulp of a value, the input
    gradient within one ulp of each of its two rounded parts (a
    statistic one f32 ulp apart may move either part's rounding); the
    statistics and parameter gradients stay f32 (1e-5)."""
    r0, r1 = (r[dtype] for r in bn_ranks)
    one = _one_process_bn(dtype)
    for k in ("mean", "var"):
        assert torch.equal(r0[k], r1[k]), k
    y = torch.cat([r0["y"], r1["y"]]).numpy()
    gx = torch.cat([r0["gx"], r1["gx"]]).numpy()
    y1, gx1 = one["y"].numpy(), one["gx"].numpy()
    if dtype == "float32":
        np.testing.assert_allclose(y, y1, rtol=1e-5,
                                   atol=1e-5 * np.abs(y1).max())
        np.testing.assert_allclose(gx, gx1, rtol=1e-5,
                                   atol=1e-5 * np.abs(gx1).max())
    else:
        assert (np.abs(y - y1) <= _bf16_ulp(y1)).all()
        x, ct, scale = bn_case()[:3]
        direct, stats = _input_grad_parts(_bf16_values(x), _bf16_values(ct),
                                          scale)
        bound = _bf16_ulp(direct) + _bf16_ulp(stats) + _bf16_ulp(gx1)
        assert (np.abs(gx - gx1) <= bound).all()
        assert (gx == gx1).mean() > 0.9
    for k in ("mean", "var"):
        assert rel_err(r0[k].numpy(), one[k].numpy()) < 1e-5, k
    for k in ("gw", "gb"):
        assert rel_err((r0[k] + r1[k]).numpy(), one[k].numpy()) < 1e-5, k
        assert rel_err(r0[k].numpy(), one[k].numpy()) > 1e-2, k  # partial


@pytest.mark.parametrize("dtype", DTYPES)
def test_sync_batchnorm_matches_flax(bn_ranks, dtype):
    """The two ranks against flax's ``BatchNorm`` (train mode, momentum
    0.9, eps 1e-5) ``jax.vjp`` on the whole batch, at
    ``test_torch_train.py::test_train_batchnorm_matches_flax``'s
    tolerances: float32 1e-5 of each max; bfloat16 the output and input
    gradient 2^-7 of the max (bf16 roundings), the statistics and the
    summed parameter gradients 1e-4."""
    import flax.linen as fnn

    r0, r1 = (r[dtype] for r in bn_ranks)
    x, ct, scale, bias, ra_mean, ra_var = bn_case()
    jdt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)

    def f(xj, params):
        return bn.apply({"params": params,
                         "batch_stats": {"mean": ra_mean, "var": ra_var}},
                        xj, mutable=["batch_stats"])

    nhwc = (0, 2, 3, 1)
    xj = jnp.asarray(x.transpose(nhwc), jdt)
    (yj, mut), vjp = jax.vjp(f, xj, {"scale": scale, "bias": bias})
    dxj, dpj = vjp((jnp.asarray(ct.transpose(nhwc), yj.dtype),
                    jax.tree_util.tree_map(jnp.zeros_like, mut)))
    y = torch.cat([r0["y"], r1["y"]]).numpy().transpose(nhwc)
    gx = torch.cat([r0["gx"], r1["gx"]]).numpy().transpose(nhwc)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert rel_err(y, np.asarray(yj, np.float32)) < tol
    assert rel_err(gx, np.asarray(dxj, np.float32)) < tol
    tol_f32 = 1e-5 if dtype == "float32" else 1e-4
    stats = mut["batch_stats"]
    assert rel_err(r0["mean"].numpy(), stats["mean"]) < tol_f32
    assert rel_err(r0["var"].numpy(), stats["var"]) < tol_f32
    assert rel_err((r0["gw"] + r1["gw"]).numpy(), dpj["scale"]) < tol_f32
    assert rel_err((r0["gb"] + r1["gb"]).numpy(), dpj["bias"]) < tol_f32


LOSS_CFG = {"model": {"input_res": 64, "output_res": 16},
            "dataset": {"max_objs": 4}}
# The head outputs of the loss case: logits near the heads' prior
# (-2.19 + N(0, 1): the heads' init, far from the clamp) and wide ones
# (N(0, 4)), where log(1 - p) for p near 1 amplifies the last bit of the
# sigmoid: the one-process port's hm_hp_loss lies 9.6e-6 from the
# reference's (and from its float64 run) there, inside the 1e-5 that
# test_torch_train.py::test_losses_match_jax holds it to.
LOGITS = {"prior": (-2.19, 1.0), "wide": (0.0, 2.0)}


def _loss_case(path) -> dict:
    """Encoded targets of 4 examples at 64x64 (16x16 maps), the first two
    with 1-2 persons each, the last two (rank 1's half) with none, so no
    peak and no joint at all; for each ``LOGITS`` variant seeded raw head
    outputs (``out_<variant>_<head>``)."""
    cfg = update_config(default_config(), LOSS_CFG)
    rng = np.random.default_rng(5)
    examples = []
    for i in range(4):
        img = rng.integers(0, 256, (96, 128, 3), np.uint8)
        anns = ([make_person(rng, 128, 96)[0] for _ in range(1 + i % 2)]
                if i < 2 else [])
        examples.append(encode_example(img, anns, cfg,
                                       np.random.default_rng(i), False))
    keys = ("hm", "hm_hp", "reg_mask", "ind", "wh", "reg", "hps_mask",
            "hps", "hp_mask", "hp_ind", "hp_offset")
    case = {k: np.stack([e[k] for e in examples]) for k in keys}
    assert case["hm"][:2].max() == 1.0 and case["hm"][2:].max() < 1.0
    assert case["hm_hp"][2:].max() < 1.0 and not case["hps_mask"][2:].any()
    chans = {"hm": 1, "wh": 2, "hps": 34, "reg": 2, "hm_hp": 17,
             "hp_offset": 2}
    for variant, (loc, scale) in LOGITS.items():
        for name, c in chans.items():
            loc_c = loc if name in ("hm", "hm_hp") else 0.0
            case[f"out_{variant}_{name}"] = rng.normal(
                loc_c, scale, (4, 16, 16, c)).astype(np.float32)
    np.savez(path, **case)
    return case


@pytest.fixture(scope="module")
def loss_ranks(tmp_path_factory):
    """The loss case and each rank's losses (``_torch_dp._loss``)."""
    tmp = tmp_path_factory.mktemp("loss")
    case = _loss_case(tmp / "case.npz")
    return case, run_ranks("loss", 2, tmp, case=tmp / "case.npz")


@pytest.mark.parametrize("variant", sorted(LOGITS))
def test_global_normalizers_match_reference(loss_ranks, variant):
    """``multi_pose_loss`` with the group on 2 ranks, rank 1's half
    holding no peak and no joint.  On both ranks the stats (the loss and
    every term) equal the port's one-process loss on the global batch
    (rtol 1e-6) and the reference's ``multi_pose_loss`` on it (rtol 1e-6
    near the prior; 1e-5 for the wide logits, the one-process port's own
    tolerance, ``LOGITS``); the ranks' mean of the returned loss is the
    global loss, and each rank's gradient at its outputs, over the world
    size, is the reference's gradient of the global loss there.  Without
    the group (each rank its own normalizers) rank 1's focal terms take
    the no-peak branch and its L1 terms divide by empty masks: far from
    the global loss, which these checks would catch."""
    from centerpose_tpu_torch.losses import multi_pose_loss

    case, ranks = loss_ranks
    prefix = f"out_{variant}_"
    outs = {k[len(prefix):]: v for k, v in case.items()
            if k.startswith(prefix)}
    targets = {k: v for k, v in case.items() if not k.startswith("out_")}
    jcfg = j_update(j_default(), LOSS_CFG)
    (want_total, want), jgrads = jax.value_and_grad(
        lambda o: jlosses.multi_pose_loss(o, {
            k: jnp.asarray(v) for k, v in targets.items()}, jcfg),
        has_aux=True)({k: jnp.asarray(v) for k, v in outs.items()})
    want = {k: float(v) for k, v in want.items()}
    _, one = multi_pose_loss(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()},
        update_config(default_config(), LOSS_CFG))
    rtol = 1e-6 if variant == "prior" else 1e-5
    for r in ranks:
        got = r[variant]["global"]["stats"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert abs(got[k] - float(one[k])) <= 1e-6 * abs(v), k
            assert abs(got[k] - v) <= rtol * abs(v), (k, got[k], v)
    mean = np.mean([r[variant]["global"]["loss"] for r in ranks])
    assert abs(mean - float(want_total)) <= rtol * float(want_total)
    for name, g in jgrads.items():
        got = np.concatenate([r[variant]["global"]["grads"][name].numpy()
                              for r in ranks]) / len(ranks)
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)
    # per-rank normalizers: rank 1's terms are not the global ones, by
    # thousands of times the tolerance
    local = ranks[1][variant]["local"]["stats"]
    for k in ("loss", "hm_loss", "hm_hp_loss"):
        assert abs(local[k] - want[k]) > 1e-2 * abs(want[k]), k


def _batches(cfg, n: int):
    loader = DataLoader(SyntheticPoseDataset(2 * n, seed=1), cfg,
                        batch_size=2, seed=cfg.train.seed)
    return [b for _, b in zip(range(n), loader.epoch(0))]


def test_ddp_world_one_bit_equal_to_plain_trainer(tmp_path):
    """The data-parallel Trainer at world size 1 (gloo) against the plain
    Trainer on the same 2 batches, Adam: the parameters, the buffers, the
    optimizer's state and the step count bit-equal (no BatchNorm sync,
    the local loss, DDP's average over one rank)."""
    cfg = update_config(default_config(), {
        "model": {"name": "res_18", "input_res": 64, "output_res": 16},
        "dataset": {"max_objs": 4}, "train": {"batch_size": 2}})
    batches = _batches(cfg, 2)
    plain = Trainer(cfg, device="cpu")
    for b in batches:
        plain.train_step(b)
    init_distributed(f"file://{tmp_path}/rdv", 1, 0, backend="gloo",
                     device="cpu", timeout=60)
    try:
        ddp = Trainer(cfg, device="cpu", group=dist.group.WORLD)
        assert ddp.ddp is not None and ddp._loss_group is None
        assert all(m.process_group is None for m in ddp.model.modules()
                   if isinstance(m, BatchNorm2d))
        for b in batches:
            ddp.train_step(b)
    finally:
        dist.destroy_process_group()
    assert bit_equal(to_host(ddp.state()), to_host(plain.state()))


def test_uneven_shards_step_together(tmp_path):
    """7 images at global batch 4 on 2 ranks: each rank's shard is cut to
    3 images, so each runs exactly one step (2 images) and the run ends
    (rank 0's fourth image would have made it a second step with no
    partner for its collectives)."""
    ranks = run_ranks("step", 2, tmp_path, name="res_18", images=7,
                      batch=4, steps=0)
    assert [len(r["losses"]) for r in ranks] == [1, 1]
    assert ranks[0]["losses"] == ranks[1]["losses"]


_FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.5)  # both builds overlap
with open(out, "wb") as f:
    f.write(b"library built from " + sys.argv[-1].encode())
print("ptxas info: fake")
"""

_BUILD = """
import sys
from pathlib import Path
import centerpose_tpu_torch.ops.dcn_cuda as dc
dc.BUILD_DIR = Path(sys.argv[1])
print(sorted(str(p) for p in dc.build_library().values()))
"""


def test_two_ranks_build_the_kernels_at_once(tmp_path):
    """Two processes (the ranks of a data-parallel run on a fresh
    checkout) build the CUDA libraries at the same moment, each with a
    stand-in ``nvcc`` that writes the library it is asked for: both get
    the same paths, each library and its compiler log is whole, and no
    temporary file is left."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert outs[0] == outs[1]
    libs = sorted(build.glob("*.so"))
    assert len(libs) == 2 and sorted(p.name for p in build.iterdir()) == \
        sorted([*(p.name for p in libs),
                *(p.with_suffix(".log").name for p in libs)])
    for lib in libs:
        assert lib.read_bytes().startswith(b"library built from ")
        assert lib.with_suffix(".log").read_text() == "ptxas info: fake\n"
