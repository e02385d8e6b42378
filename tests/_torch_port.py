"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
dla_34 snapshot as a JAX variable tree and as a torch model, and matching
configs of both packages."""

from __future__ import annotations

import re
from pathlib import Path

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
