"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
dla_34 snapshot as a JAX variable tree and as a torch model, matching
configs of both packages, and what feeds each BatchNorm of the reference's
compiled graph."""

from __future__ import annotations

import re
from pathlib import Path
from unittest import mock

import numpy as np

NPZ = str(Path(__file__).resolve().parent.parent
          / "output" / "dla34_hard_artifact" / "params_f16.npz")

_KEY = re.compile(r"\['([^']+)'\]")


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


def bn_inputs(dcn_impl: str = "xla", res: int = 128, name: str = "dla_34",
              npz: str = NPZ, head_conv: int = 256) -> dict:
    """What feeds each BatchNorm of the reference's compiled bf16 eval graph
    (``name`` with the snapshot ``npz``, ``res`` x ``res``): {BatchNorm
    scope: (opcode, dtype)} of the instruction that BatchNorm's ``x -
    mean`` reads, found by following fusion parameters to their callers'
    operands and f32 widenings and bitcasts to their operands.  A bf16
    ``convert`` there means the value was rounded before BatchNorm
    promoted it to f32."""
    import jax
    import jax.numpy as jnp

    import centerpose_tpu.ops.dcn_pallas as dp
    from centerpose_tpu.models.factory import create_model as j_create

    model = j_create(jax_cfg(res, dcn_impl, compute_dtype="bfloat16",
                             name=name, head_conv=head_conv))
    with mock.patch.object(dp, "_INTERPRET", [True]):
        text = jax.jit(lambda v, a: model.apply(v, a, train=False)).lower(
            jax_variables(npz), jnp.zeros((1, res, res, 3))).compile().as_text()
    comps, comp, callers = {}, None, {}
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
                opname=opname.group(1) if opname else "")
            if calls:
                callers[calls.group(1)] = (comp, name)

    def source(comp, name):
        i = comps[comp][name]
        if i["op"] == "parameter" and comp in callers:
            caller, inst = callers[comp]
            return source(caller, comps[caller][inst]["operands"][int(i["args"])])
        if i["op"] == "bitcast" or (i["op"] == "convert" and i["dt"] == "f32"):
            return source(comp, i["operands"][0])
        return i["op"], i["dt"]

    out = {}
    for comp, insts in comps.items():
        for i in insts.values():
            if i["op"] == "subtract" and i["opname"].endswith("BatchNorm_0/sub"):
                scope = i["opname"].split("/", 2)[2][:-len("BatchNorm_0/sub")]
                scope = scope.rstrip("/")  # "" at the top level
                out.setdefault(scope, source(comp, i["operands"][0]))
    return out
