"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
dla_34 snapshot as a JAX variable tree and as a torch model, matching
configs of both packages, and what feeds each BatchNorm of the reference's
compiled graph.  A test module that imports ``release_resources`` and
``release_compiled`` (autouse fixtures) deletes each test's files and hands
its freed memory back to the system after each test, and its compiled
reference programs at its end."""

from __future__ import annotations

import ctypes
import ctypes.util
import gc
import os
import re
import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

NPZ = str(Path(__file__).resolve().parent.parent
          / "output" / "dla34_hard_artifact" / "params_f16.npz")

_KEY = re.compile(r"\['([^']+)'\]")

# XLA CPU compiler options for the reference's big jitted steps: LLVM at
# its lowest optimisation level, which leaves the compiled HLO (where it
# rounds, what it fuses; instruction names aside) as it is and takes a
# third to a fifth of the compile time (hrnet_w32's train step: ~50 s
# against ~170 s)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def share_cores_among_workers() -> int:
    """Under pytest-xdist, give each worker's torch its share of the cores
    and return it.  Every worker otherwise runs torch's default of one
    OpenMP thread per core, which oversubscribes the machine by the worker
    count and makes the port's tests 10-40x slower than alone."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 0:
        torch.set_num_threads(
            max(1, len(os.sched_getaffinity(0)) // workers))
    return torch.get_num_threads()


share_cores_among_workers()


def _malloc_trim():
    """glibc's ``malloc_trim(0)``, or nothing where the C library has
    none."""
    name = ctypes.util.find_library("c")
    trim = getattr(ctypes.CDLL(name), "malloc_trim", None) if name else None
    return (lambda: trim(0)) if trim is not None else (lambda: None)


_TRIM = _malloc_trim()


@pytest.fixture(autouse=True)
def release_resources(tmp_path):
    """After each test of a module that imports it: delete what the test
    wrote to its ``tmp_path`` and hand the C heap's free pages back to the
    system.  pytest keeps every test's directory to the end of the run
    (and the last three runs'): a test's directory holds up to 450 MB
    (checkpoints, snapshots as npz, the ranks' results), 4.6 GB in one
    tier-1 run, and a checkpoint write that found the disk full failed a
    test (``torch.save``: "iostream error").  Compiling the reference's
    programs and running the port's big models leaves a worker's freed
    memory in glibc's arenas, so under xdist each worker's resident size
    only grew (one to 6.6 GiB, the six together to ~23 GiB on 8 cores);
    after one compile of four families' bf16 graphs a trim took a process
    from 1175 to 626 MiB.  Garbage in cycles waits for the module's end
    (``release_compiled``): one collection takes 0.2 s or more in a process
    that imported both packages."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)
    _TRIM()


@pytest.fixture(autouse=True, scope="module")
def release_compiled():
    """At the end of a module that imports it: drop JAX's compiled
    programs and caches too (the module's tests may share them; the next
    module's do not) and the garbage in cycles, then trim the heap as
    ``release_resources``."""
    yield
    import sys

    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()
    gc.collect()
    _TRIM()


class FakeCudaTensor(torch.Tensor):
    """Stands in for a CUDA tensor (this machine has none): a tensor with
    no storage on the CUDA device, whose operators go on to the CUDA
    kernels registered for them (K1's operator among them)."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(cls, t.shape,
                                                   dtype=t.dtype,
                                                   device="cuda")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        with torch._C._DisableTorchDispatch():
            return func(*args, **(kwargs or {}))


def jax_variables(path: str = NPZ) -> dict:
    """The snapshot as a nested {params, batch_stats} dict of float32
    arrays (what ``Module.apply`` takes; no flax init needed)."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            group, _, p = key.partition(":")
            node = out.setdefault(group, {})
            parts = _KEY.findall(p)
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.asarray(data[key], np.float32)
    return out


def dla_overrides(res: int = 128, dcn_impl: str = "xla", **model) -> dict:
    m = {"name": "dla_34", "input_res": res, "output_res": res // 4,
         "head_conv": 256, "dcn_impl": dcn_impl}
    m.update(model)
    return {"model": m}


def jax_cfg(res: int = 128, dcn_impl: str = "xla", test: dict | None = None,
            **model):
    from centerpose_tpu.config import default_config, update_config

    ov = dla_overrides(res, dcn_impl, **model)
    if test:
        ov["test"] = dict(test)
    return update_config(default_config(), ov)


def torch_cfg(res: int = 128, dcn_impl: str = "xla", test: dict | None = None,
              **model):
    from centerpose_tpu_torch.config import default_config, update_config

    ov = dla_overrides(res, dcn_impl, **model)
    if test:
        ov["test"] = dict(test)
    return update_config(default_config(), ov)


def torch_model(cfg, path: str = NPZ):
    """dla_34 with the snapshot, float32, channels_last, eval, on the CPU."""
    from centerpose_tpu_torch.models.common import to_channels_last
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.weights import load_npz

    model = create_model(cfg)
    load_npz(model, path)
    return to_channels_last(model).eval()


def seeded(shapes: dict, seed: int) -> dict:
    """Variables in the shapes of the reference's tree (``jax.eval_shape``
    of its init, ``shapes``: the init itself takes up to a minute per
    backbone on the CPU), made from a seed at its initialisers' scales:
    conv kernels He-normal over their fan-in (transposed ones too, so
    asymmetric, where the reference's bilinear init is symmetric),
    BatchNorm scales near 1, running variances in [0.5, 1.5], BiFPN fusion
    weights near 1, means and biases near 0."""
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

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


def shapes(model, x) -> dict:
    """``jax.eval_shape`` of the reference module's init on ``x``."""
    import jax

    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                             train=False))


CONV_BN_KINDS = ["k3", "k1", "strided", "dilated", "grouped", "depthwise",
                 "deconv"]


def conv_bn_case(kind: str):
    """(reference bf16 module, port module, input channels) of one conv ->
    BatchNorm hand-off of ``CONV_BN_KINDS``."""
    import jax.numpy as jnp

    from centerpose_tpu.models import common as jcommon
    from centerpose_tpu_torch.models import common

    cin, cout = 16, 24
    if kind == "deconv":
        return jcommon.DeconvBN(cout, dtype=jnp.bfloat16), \
            common.DeconvBN(cin, cout), cin
    kw = {"k3": {}, "k1": {"kernel": 1}, "strided": {"strides": 2},
          "dilated": {"dilation": 2}, "grouped": {"groups": 4},
          "depthwise": {"groups": cin}}[kind]
    if kind == "depthwise":
        cout = cin
    return (jcommon.ConvBN(cout, dtype=jnp.bfloat16, **kw),
            common.ConvBN(cin, cout, **kw), cin)


def port_state_dict(variables: dict) -> dict:
    """A reference variable tree ({params, batch_stats}) as the port's
    state dict, through an .npz as the snapshots cross
    (``weights.state_dict_from_npz``: renames, layouts, the transposed
    conv's flip)."""
    import tempfile

    from centerpose_tpu.train.checkpoints import save_params_npz
    from centerpose_tpu_torch.weights import state_dict_from_npz

    with tempfile.TemporaryDirectory() as d:
        save_params_npz(variables, f"{d}/v.npz")
        return state_dict_from_npz(f"{d}/v.npz")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def bit_equal(a, b) -> bool:
    """Nested states (dicts, lists, tensors, numbers) equal bit for bit:
    each tensor's dtype, shape and bytes."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.reshape(-1).contiguous().view(torch.uint8),
                    b.reshape(-1).contiguous().view(torch.uint8)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(bit_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(bit_equal, a, b))
    return a == b


_HLO_INST = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = (\w+)\[[^\]]*\]\S* "
                       r"([\w\-]+)\((.*?)\)(.*)$")
# value-preserving ops a reading looks through to the value they move
_MOVES = {"bitcast", "copy", "transpose", "reshape", "reverse", "pad", "slice"}


def _parse_hlo(text: str):
    """(computations {name: {instruction: fields}}, fused computation ->
    (caller computation, instruction), computation -> its ROOT) of
    compiled HLO text."""
    comps, comp, callers, roots = {}, None, {}, {}
    for line in text.splitlines():
        head = re.match(r"^(?:ENTRY )?%([\w.\-]+) .*\{$", line)
        if head:
            comp = head.group(1)
            comps[comp] = {}
        elif line.startswith("}"):
            comp = None
        elif comp is not None and (m := _HLO_INST.match(line)):
            name, dt, op, args, rest = m.groups()
            calls = re.search(r"calls=%([\w.\-]+)", rest)
            opname = re.search(r'op_name="([^"]+)"', rest)
            comps[comp][name] = dict(
                dt=dt, op=op, args=args,
                operands=re.findall(r"%([\w.\-]+)", args),
                opname=opname.group(1) if opname else "",
                calls=calls.group(1) if calls else None)
            if line.lstrip().startswith("ROOT"):
                roots[comp] = name
            if calls:
                callers[calls.group(1)] = (comp, name)
    return comps, callers, roots


def _source(hlo, comp: str, name: str) -> tuple:
    """(opcode, dtype) of the instruction whose value ``name`` carries:
    fusion parameters are followed to their callers' operands, fusions to
    their roots, f32 widenings and ``_MOVES`` to their operands.  A bf16
    ``convert`` means the value was rounded to bf16 there."""
    comps, callers, roots = hlo
    i = comps[comp][name]
    if i["op"] == "parameter" and comp in callers:
        caller, inst = callers[comp]
        return _source(hlo, caller,
                       comps[caller][inst]["operands"][int(i["args"])])
    if i["op"] == "fusion" and i["calls"] in roots:
        return _source(hlo, i["calls"], roots[i["calls"]])
    if i["op"] in _MOVES or (i["op"] == "convert" and i["dt"] == "f32"):
        return _source(hlo, comp, i["operands"][0])
    return i["op"], i["dt"]


def _forward(opname: str, train: bool) -> bool:
    return not train or ("jvp(" in opname and "transpose(" not in opname)


def _bn_feeds(hlo, train: bool = False) -> dict:
    out = {}
    for comp, insts in hlo[0].items():
        for i in insts.values():
            if (i["op"] == "subtract" and _forward(i["opname"], train)
                    and i["opname"].endswith("BatchNorm_0/sub")):
                scope = i["opname"].split("/", 2)[2][:-len("BatchNorm_0/sub")]
                scope = scope.rstrip("/")  # "" at the top level
                out.setdefault(scope, _source(hlo, comp, i["operands"][0]))
    return out


def bn_inputs(dcn_impl: str = "xla", res: int = 128, name: str = "dla_34",
              npz: str = NPZ, head_conv: int = 256) -> dict:
    """What feeds each BatchNorm of the reference's compiled bf16 eval graph
    (``name`` with the snapshot ``npz``, ``res`` x ``res``): {BatchNorm
    scope: (opcode, dtype)} of the instruction that BatchNorm's ``x -
    mean`` reads (``_source``).  A bf16 ``convert`` there means the value
    was rounded before BatchNorm promoted it to f32."""
    import jax
    import jax.numpy as jnp

    import centerpose_tpu.ops.dcn_pallas as dp
    from centerpose_tpu.models.factory import create_model as j_create

    model = j_create(jax_cfg(res, dcn_impl, compute_dtype="bfloat16",
                             name=name, head_conv=head_conv))
    with mock.patch.object(dp, "_INTERPRET", [True]):
        text = jax.jit(lambda v, a: model.apply(v, a, train=False)).lower(
            jax_variables(npz), jnp.zeros((1, res, res, 3))).compile().as_text()
    return _bn_feeds(_parse_hlo(text))


def loss_targets(cfg, batch: int = 2, seed: int = 0) -> dict:
    """Seeded training targets at ``cfg``'s output resolution (every key
    ``multi_pose_loss`` reads, ``max_objs`` objects), float32 / int32."""
    r = np.random.default_rng(seed)
    o, k, j = cfg.model.output_res, cfg.dataset.max_objs, cfg.model.num_joints
    hm = r.uniform(0, 0.99, (batch, o, o, 1)).astype(np.float32)
    hm[:, o // 2, o // 3, 0] = 1.0
    return {
        "hm": hm,
        "hm_hp": r.uniform(0, 0.99, (batch, o, o, j)).astype(np.float32),
        "wh": r.uniform(1, 9, (batch, k, 2)).astype(np.float32),
        "reg": r.uniform(0, 1, (batch, k, 2)).astype(np.float32),
        "hps": r.normal(size=(batch, k, 2 * j)).astype(np.float32),
        "ind": r.integers(0, o * o, (batch, k)).astype(np.int32),
        "reg_mask": (r.random((batch, k)) > 0.3).astype(np.float32),
        "hps_mask": (r.random((batch, k, 2 * j)) > 0.3).astype(np.float32),
        "hp_offset": r.uniform(0, 1, (batch, k * j, 2)).astype(np.float32),
        "hp_ind": r.integers(0, o * o, (batch, k * j)).astype(np.int32),
        "hp_mask": (r.random((batch, k * j)) > 0.5).astype(np.float32),
    }


def train_step_reading(dcn_impl: str = "xla", res: int = 128,
                       name: str = "dla_34", npz: str = NPZ,
                       head_conv: int = 256) -> dict:
    """Where the reference's jitted bf16 train step rounds: the forward in
    train mode and ``jax.grad`` of ``multi_pose_loss`` (batch 2, seeded
    targets), compiled, for ``name`` with the weights ``npz`` at ``res`` x
    ``res``.  Returns

    - ``bn``: {BatchNorm scope: (opcode, dtype)} that each forward
      BatchNorm's ``x - mean`` reads, as ``bn_inputs``;
    - ``convs``: [(pass, opcode, op_name, (source of operand 0, of operand
      1))] for every convolution and dot, ``pass`` "fwd" for the forward
      and "bwd" for the rest (XLA names many backward convs nothing);
    - ``head_bias``: {head: (dtype of its output conv's bias sum, source of
      the conv operand of that sum)}."""
    import jax
    import jax.numpy as jnp

    import centerpose_tpu.losses as jlosses
    import centerpose_tpu.ops.dcn_pallas as dp
    from centerpose_tpu.models.factory import create_model as j_create

    cfg = jax_cfg(res, dcn_impl, compute_dtype="bfloat16", name=name,
                  head_conv=head_conv)
    model = j_create(cfg)
    variables = jax_variables(npz)

    def loss_fn(params, bs, x, targets):
        out, mut = model.apply({"params": params, "batch_stats": bs}, x,
                               train=True, mutable=["batch_stats"])
        return jlosses.multi_pose_loss(out, targets, cfg)[0], mut

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with mock.patch.object(dp, "_INTERPRET", [True]):
        text = step.lower(variables["params"], variables["batch_stats"],
                          jnp.zeros((2, res, res, 3)), loss_targets(cfg)
                          ).compile(compiler_options=FAST_COMPILE).as_text()
    hlo = _parse_hlo(text)
    convs, head_bias = [], {}
    for comp, insts in hlo[0].items():
        for i in insts.values():
            fwd = _forward(i["opname"], True)
            if i["op"] in ("convolution", "dot"):
                convs.append(("fwd" if fwd else "bwd", i["op"], i["opname"],
                              tuple(_source(hlo, comp, o)
                                    for o in i["operands"][:2])))
            m = re.search(r"/(\w+)_out/add$", i["opname"])
            if fwd and m and i["op"] == "add":
                srcs = [_source(hlo, comp, o) for o in i["operands"]]
                conv = [s for s in srcs if s[0] != "broadcast"]
                head_bias.setdefault(m.group(1), (i["dt"], conv[0]))
    return {"bn": _bn_feeds(hlo, True), "convs": convs,
            "head_bias": head_bias}


def port_bn_scopes(model) -> set:
    """The scopes of the port model's BatchNorms in the reference's
    naming (``a/b/c`` for ``a.b.c.BatchNorm_0``)."""
    import torch

    return {n.replace(".", "/")[:-len("BatchNorm_0")].rstrip("/")
            for n, m in model.named_modules()
            if isinstance(m, torch.nn.BatchNorm2d)}


def check_train_reading(reading: dict, port_scopes: set, dcn_sites: set) -> None:
    """The premise of the train-mode ``conv_bn`` and heads, asserted on one
    reading: every BatchNorm of the port is one of the reference's forward
    BatchNorms; each reads an unrounded f32 conv result (a convolution,
    dot or, where XLA reduced a 1x1 conv on a tiny map, multiply) except
    at the DCN sites ``dcn_sites``, which read a bf16-rounded value; every
    convolution and dot outside the DCN sites' own ops, forward and
    backward, reads two bf16-rounded operands (the backward's cotangents
    are rounded before each conv); each head's output bias sum is f32 on a
    rounded conv result."""
    bn = reading["bn"]
    assert set(bn) == port_scopes, sorted(set(bn) ^ port_scopes)
    for scope, src in bn.items():
        if scope in dcn_sites:
            assert src == ("convert", "bf16"), (scope, src)
        else:
            assert src[1] == "f32" and src[0] in (
                "convolution", "dot", "multiply"), (scope, src)
    rounded = ("convert", "bf16")
    n_bwd = 0
    for pass_, op, name, srcs in reading["convs"]:
        if "DCN_0" in name:
            continue
        n_bwd += pass_ == "bwd"
        assert srcs == (rounded, rounded), (pass_, op, name, srcs)
    assert n_bwd > 0
    assert reading["head_bias"] and all(
        v == ("f32", rounded) for v in reading["head_bias"].values()), \
        reading["head_bias"]


def check_dla34_train_reading(dcn_impl: str) -> None:
    """``check_train_reading`` of dla_34's train step at 128x128 on the
    snapshot under ``dcn_impl``: 55 BatchNorms, the 16 DCN sites among
    them."""
    reading = train_step_reading(dcn_impl, 128)
    model = torch_model(torch_cfg(128, dcn_impl))
    dcn = {n.replace(".", "/") for n, m in model.named_modules()
           if type(m).__name__ == "DeformConv"}
    assert len(reading["bn"]) == 55 and len(dcn) == 16
    check_train_reading(reading, port_bn_scopes(model), dcn)


def check_family_reading(name: str, tmp_path) -> None:
    """``check_train_reading`` of ``name``'s bf16 train step at 64x64 on
    seeded weights (``seeded``) saved to ``tmp_path``."""
    import jax.numpy as jnp

    from centerpose_tpu.config import default_config as j_default
    from centerpose_tpu.config import update_config as j_update
    from centerpose_tpu.models.factory import create_model as j_create
    from centerpose_tpu.train.checkpoints import save_params_npz
    from centerpose_tpu_torch.config import default_config, update_config
    from centerpose_tpu_torch.models.factory import create_model

    ov = {"model": {"name": name, "input_res": 64, "output_res": 16}}
    model = j_create(j_update(j_default(), ov))
    path = str(tmp_path / f"{name}.npz")
    save_params_npz(seeded(shapes(model, jnp.zeros((1, 64, 64, 3))), 0),
                    path)
    reading = train_step_reading("xla", 64, name, path, head_conv=64)
    # flax's names of modules inside lists (``stage4_m2/fuse_1_0``) lose
    # their ``ClassName_n`` prefix scopes in the op names
    reading["bn"] = {re.sub(r"[^/]+\._\w+/", "", s): v
                     for s, v in reading["bn"].items()}
    port = create_model(update_config(default_config(), ov))
    check_train_reading(reading, port_bn_scopes(port), set())
