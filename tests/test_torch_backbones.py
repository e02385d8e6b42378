"""The other backbones of the model factory, the port against the
reference: every family's forward at 64x64 in float32 on seeded weights in
the reference's variable tree passed across as an .npz, the mapped key
sets of the deeper variants, strict loads of the committed snapshots, the
transposed conv's weight mapping, the factory's 14 names, and the bf16
conv -> BatchNorm hand-off of every family against the reference's
compiled graph."""

from __future__ import annotations

import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from centerpose_tpu.config import default_config as j_default
from centerpose_tpu.config import update_config as j_update
from centerpose_tpu.models import common as jcommon
from centerpose_tpu.models.factory import MODEL_FACTORY as J_FACTORY
from centerpose_tpu.models.factory import create_model as j_create
from centerpose_tpu.train.checkpoints import save_params_npz
from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.models import common
from centerpose_tpu_torch.models.common import to_channels_last
from centerpose_tpu_torch.models.factory import MODEL_FACTORY, create_model
from centerpose_tpu_torch.weights import (load_npz, npz_arrays,
                                          state_dict_from_npz, torch_key)

from _torch_port import bn_inputs, jax_variables, rel_err

ROOT = Path(__file__).resolve().parent.parent
SNAPSHOTS = {  # name -> (artifact, keys)
    "res_18": ("res18", 139),
    "mobilenetv3": ("mbv3", 296),
    "hrnet_w32": ("hrnet32", 1549),
}
FAMILIES = ["res_18", "res_50", "mobilenetv2", "mobilenetv3", "hrnet_w32",
            "shufflenetv2", "hardnet", "darknet", "efficientnet"]
RES = 64
TOL_F32 = 1e-4  # max |port - reference| / max |reference|, every head
# bf16, a snapshot at 128x128, max |port - reference| / max |reference| per
# head: both round the same values at the same points and differ in the
# order of the f32 sums of each conv, which moves a value across a bf16
# rounding boundary now and then; the reference's own bf16-to-f32
# distance there is 3.4e-3 to 1.4e-2
TOL_BF16 = 1.5e-2


def _overrides(name: str) -> dict:
    return {"model": {"name": name, "input_res": RES, "output_res": RES // 4}}


def _seeded(shapes: dict, seed: int) -> dict:
    """Variables in the shapes of the reference's tree (``jax.eval_shape``
    of its init: the init itself takes up to a minute per backbone on the
    CPU), made from a seed at its initialisers' scales: conv kernels
    He-normal over their fan-in (transposed ones too, so asymmetric, where
    the reference's bilinear init is symmetric), BatchNorm scales near 1,
    running variances in [0.5, 1.5], BiFPN fusion weights near 1, means
    and biases near 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flatten_dict(shapes).items():
        shape, name = leaf.shape, path[-1]
        if name == "kernel":
            v = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale" or name[:2] in ("td", "bu"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:  # bias, mean
            v = 0.1 * rng.normal(size=shape)
        out[path] = jnp.asarray(v, jnp.float32)
    return unflatten_dict(out)


def _shapes(model, x) -> dict:
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                             train=False))


@pytest.fixture(scope="module")
def npz_dir():
    with tempfile.TemporaryDirectory() as d:
        yield Path(d)


def _reference(name: str, npz_dir: Path, seed: int = 0):
    """(reference model, perturbed variables, their .npz path)."""
    model = j_create(j_update(j_default(), _overrides(name)))
    variables = _seeded(_shapes(model, jnp.zeros((1, RES, RES, 3))), seed)
    path = npz_dir / f"{name}.npz"
    save_params_npz(variables, str(path))
    return model, variables, path


def _port(name: str, path=None) -> torch.nn.Module:
    model = create_model(update_config(default_config(), _overrides(name)))
    if path is not None:
        load_npz(model, str(path))
    return to_channels_last(model).eval()


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference_f32(name, npz_dir):
    jmodel, variables, path = _reference(name, npz_dir)
    x = np.random.default_rng(5).normal(size=(2, RES, RES, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(name, path)(torch.from_numpy(x))
    assert set(got) == set(want)
    for head in want:
        w = np.asarray(want[head])
        assert got[head].shape == w.shape, head
        err = rel_err(got[head].numpy(), w)
        assert err <= TOL_F32, (name, head, err)


@pytest.mark.parametrize("name", ["res_34", "res_101", "res_152", "hrnet_w48"])
def test_deeper_variants_map_every_key(name):
    """The mapped keys of the reference's variable tree are the port's
    state dict (BatchNorm counters aside), shapes included; no forward."""
    jmodel = j_create(j_update(j_default(), _overrides(name)))
    want = {}
    shapes = _shapes(jmodel, jnp.zeros((1, RES, RES, 3)))
    for path, leaf in flatten_dict(shapes).items():
        key = f"{path[0]}:" + "".join(f"['{p}']" for p in path[1:])
        want[torch_key(key)] = tuple(leaf.shape)
    sd = _port(name).state_dict()
    got = {k: tuple(v.shape) for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    assert got.keys() == want.keys()
    for k, shape in want.items():
        # conv kernels HWIO -> OIHW, transposed ones -> [in, out, kh, kw]
        assert sorted(got[k]) == sorted(shape), (k, got[k], shape)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_snapshot_loads_strictly(name):
    artifact, n_keys = SNAPSHOTS[name]
    path = ROOT / "output" / f"{artifact}_hard_artifact" / "params_f16.npz"
    sd = state_dict_from_npz(str(path))
    assert len(sd) == n_keys
    model = _port(name, path)  # strict: nothing left over either way
    with np.load(path) as data:
        back = npz_arrays(model.state_dict(), data.files)
        for key in data.files:
            np.testing.assert_array_equal(back[key],
                                          data[key].astype(np.float32))


def test_deconv_bn_maps_flax_conv_transpose_with_the_flip():
    """flax's ConvTranspose(k4, s2, "SAME") through weights.py equals the
    port's DeconvBN on an asymmetric kernel and a non-square input; the
    same kernel mapped without the spatial flip does not."""
    jmod = jcommon.DeconvBN(5)
    x = np.random.default_rng(1).normal(size=(2, 6, 10, 3)).astype(np.float32)
    variables = _seeded(_shapes(jmod, jnp.asarray(x)), 2)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/deconv.npz"
        save_params_npz(variables, path)
        sd = state_dict_from_npz(path)
    port = common.DeconvBN(3, 5).eval()
    port.load_state_dict({**sd, "BatchNorm_0.num_batches_tracked":
                          torch.zeros((), dtype=torch.long)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, 12, 20, 5)
        assert rel_err(got, want) <= TOL_F32
        kernel = np.asarray(variables["params"]["ConvTranspose_0"]["kernel"])
        port.ConvTranspose_0.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        unflipped = port(xt).permute(0, 2, 3, 1).numpy()
    assert rel_err(unflipped, want) > 0.1


def test_factory_builds_all_14_names():
    assert sorted(MODEL_FACTORY) == sorted(J_FACTORY) and len(MODEL_FACTORY) == 14
    x = torch.zeros(1, RES, RES, 3)
    for name in ("res_34", "mobilenetv2", "darknet"):
        with torch.no_grad():
            out = _port(name)(x)
        assert out["hm"].shape == (1, RES // 4, RES // 4, 1)


@pytest.mark.parametrize("name,flip", [("res_18", False), ("res_18", True),
                                       ("mobilenetv3", False),
                                       ("hrnet_w32", False)])
def test_detector_serves_snapshot_like_jax(name, flip):
    """The slice as a whole: the ``Detector`` on a committed snapshot at
    128x128, float32, against the JAX ``Detector`` on the same weights and
    frames (with flip test for res_18)."""
    from centerpose_tpu.inference.detector import Detector as JaxDetector
    from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
    from centerpose_tpu_torch.inference.detector import Detector

    from _torch_port import jax_variables

    artifact, _ = SNAPSHOTS[name]
    path = str(ROOT / "output" / f"{artifact}_hard_artifact" / "params_f16.npz")
    ov = {"model": {"name": name, "input_res": 128, "output_res": 32},
          "test": {"flip_test": flip}}
    jd = JaxDetector(j_update(j_default(), ov), variables=jax_variables(path))
    td = Detector(update_config(default_config(), ov),
                  state_dict_from_npz(path), device="cpu")
    ds = SyntheticEvalDataset(2, seed=3, hard=True)
    batch = np.concatenate([jd.pre_process(ds.get_raw(i)[0])[0]
                            for i in range(2)])
    want = jd.run_batch(batch)
    got = td.run_batch(batch)
    assert got.shape == want.shape == (2, 100, 40)
    np.testing.assert_allclose(got[:, :, 4], want[:, :, 4], atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# BatchNorms whose output no head reads, which XLA drops from the compiled
# graph: the last hrnet module's fuse into branches 1-3, the last BiFPN
# layer's bottom-up path
DEAD_BN = {"hrnet_w32": r"stage4_m2/fuse_[123]_", "efficientnet": r"bifpn1/bu"}


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_feeds_batchnorm_an_f32_conv(name, npz_dir):
    """The premise of ``models/common.conv_bn`` in every family: in the
    reference's compiled bf16 eval graph each BatchNorm reads its conv's
    (or, for a 1x1, its dot's) f32 result, never a bf16-rounded value;
    those BatchNorms are the port's, less the ones no head reads."""
    _, _, path = _reference(name, npz_dir)
    feeds = {re.sub(r"[^/]+\._\w+/", "", scope): src for scope, src in
             bn_inputs("xla", RES, name, str(path), head_conv=64).items()}
    port = {n.replace(".", "/")[:-len("BatchNorm_0")].rstrip("/")
            for n, m in _port(name).named_modules()
            if isinstance(m, torch.nn.BatchNorm2d)}
    port = {n for n in port
            if not (name in DEAD_BN and re.match(DEAD_BN[name], n))}
    assert set(feeds) == port, sorted(set(feeds) ^ port)
    bad = {s: src for s, src in feeds.items()
           if src not in (("convolution", "f32"), ("dot", "f32"))}
    assert not bad, bad


def _conv_bn_case(kind: str):
    """(reference module, port module, input channels) of one conv ->
    BatchNorm hand-off."""
    cin, cout = 16, 24
    if kind == "deconv":
        return jcommon.DeconvBN(cout, dtype=jnp.bfloat16), \
            common.DeconvBN(cin, cout), cin
    kw = {"k3": {}, "k1": {"kernel": 1}, "strided": {"strides": 2},
          "dilated": {"dilation": 2}, "grouped": {"groups": 4},
          "depthwise": {"groups": cin}}[kind]
    if kind == "depthwise":
        cout = cin
    jargs = dict(kw)
    targs = {("strides" if k == "strides" else k): v for k, v in kw.items()}
    return (jcommon.ConvBN(cout, dtype=jnp.bfloat16, **jargs),
            common.ConvBN(cin, cout, **targs), cin)


@pytest.mark.parametrize("kind", ["k3", "k1", "strided", "dilated",
                                  "grouped", "depthwise", "deconv"])
def test_conv_bn_bf16_bit_equal_to_reference(kind):
    """One ``ConvBN`` / ``DeconvBN`` in bf16 eval mode against the jitted
    reference module on the same weights: bit-equal outputs, as the conv's
    f32 result reaches BatchNorm in both (a bf16 conv that rounds its
    result first leaves 86-88% equal)."""
    jmod, port, cin = _conv_bn_case(kind)
    x = np.random.default_rng(3).normal(size=(2, 12, 20, cin))
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = _seeded(_shapes(jmod, xb), 4)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a))(
        variables, xb).astype(jnp.float32))
    with tempfile.TemporaryDirectory() as d:
        save_params_npz(variables, f"{d}/m.npz")
        sd = state_dict_from_npz(f"{d}/m.npz")
    port.load_state_dict({**sd, "BatchNorm_0.num_batches_tracked":
                          torch.zeros((), dtype=torch.long)})
    port = common.to_compute_dtype(port.eval(), torch.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    assert np.mean(got == want) >= 0.99, np.mean(got == want)


@pytest.mark.parametrize("name", ["res_18", "mobilenetv3"])
def test_snapshot_bf16_heads_near_reference(name):
    """A committed snapshot in bf16 eval mode at 128x128, the port's heads
    against the jitted reference's bf16 heads (TOL_BF16)."""
    artifact, _ = SNAPSHOTS[name]
    path = str(ROOT / "output" / f"{artifact}_hard_artifact" / "params_f16.npz")
    ov = {"model": {"name": name, "input_res": 128, "output_res": 32,
                    "compute_dtype": "bfloat16"}}
    jmodel = j_create(j_update(j_default(), ov))
    x = np.random.default_rng(11).normal(size=(1, 128, 128, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        jax_variables(path), jnp.asarray(x))
    model = create_model(update_config(default_config(), ov))
    load_npz(model, path)
    model = common.to_compute_dtype(to_channels_last(model).eval(),
                                    torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for head, w in want.items():
        err = rel_err(got[head].float().numpy(), np.asarray(w))
        assert err <= TOL_BF16, (name, head, err)
