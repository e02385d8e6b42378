"""Weight bridge: the JAX package's flat ``.npz`` snapshots -> state dicts.

A snapshot written by ``save_params_npz`` (``train/checkpoints.py``) holds
one array per leaf of the flax variable tree, keyed
``params:['a']['b']['kernel']`` or ``batch_stats:['a']['b']['mean']``, with
the params often stored as float16.  The port's modules carry the flax
submodule names, so a key becomes a state-dict key by joining its path with
dots and renaming the leaf:

* conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` OIHW;
* DCN ``kernel`` [3, 3, Cin, Cout] and ``conv_offset_mask/kernel``
  [3, 3, Cin, 27] -> ``weight``, kept in the DCN op's layout (om channels
  0..17 are the (dy, dx) offsets per tap, 18..26 the mask logits);
* BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` -> ``weight`` /
  ``bias`` / ``running_mean`` / ``running_var`` (eps 1e-5 on both sides).

Arrays are cast to float32.  Only numpy reads the file.  ``npz_arrays``
maps the other way, for comparing a port's parameters, gradients or
statistics with the JAX tree key by key.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

_PATH = re.compile(r"\['([^']+)'\]")
_DCN_PARENTS = ("DCN_0", "conv_offset_mask")
_STATS = {"mean": "running_mean", "var": "running_var"}


def torch_key(npz_key: str) -> str:
    """State-dict key of one snapshot key."""
    group, _, path = npz_key.partition(":")
    parts = _PATH.findall(path)
    if not parts or "".join(f"['{p}']" for p in parts) != path:
        raise KeyError(f"unparsed snapshot key {npz_key!r}")
    leaf = parts[-1]
    if group == "batch_stats":
        if leaf not in _STATS:
            raise KeyError(f"unknown batch_stats leaf in {npz_key!r}")
        leaf = _STATS[leaf]
    elif group == "params":
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}.get(leaf)
        if leaf is None:
            raise KeyError(f"unknown params leaf in {npz_key!r}")
    else:
        raise KeyError(f"unknown group in {npz_key!r}")
    return ".".join(parts[:-1] + [leaf])


def _is_conv_kernel(npz_key: str) -> bool:
    parts = _PATH.findall(npz_key.partition(":")[2])
    return (npz_key.startswith("params:") and parts[-1] == "kernel"
            and parts[-2] not in _DCN_PARENTS)


def state_dict_from_npz(path: str) -> Dict[str, torch.Tensor]:
    """Every key of the snapshot, mapped; float32 tensors on the CPU."""
    out: Dict[str, torch.Tensor] = {}
    with np.load(path) as data:
        for key in data.files:
            arr = np.asarray(data[key], dtype=np.float32)
            if _is_conv_kernel(key):
                if arr.ndim != 4:
                    raise ValueError(f"{key}: conv kernel of rank {arr.ndim}")
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            name = torch_key(key)
            if name in out:
                raise KeyError(f"two snapshot keys map to {name!r}")
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def npz_arrays(tensors: Dict[str, torch.Tensor], npz_keys) -> Dict[str, np.ndarray]:
    """For each snapshot key, the float32 numpy array in the snapshot's
    layout of the tensor that key maps to in ``tensors`` (a state dict, or
    the gradients keyed like it): the inverse of ``state_dict_from_npz``."""
    out = {}
    for key in npz_keys:
        arr = tensors[torch_key(key)].detach().float().cpu().numpy()
        if _is_conv_kernel(key):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[key] = arr
    return out


def load_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a mapped snapshot into ``model`` strictly: every snapshot key
    must land on a parameter or running statistic, and every one of those
    must come from the snapshot (BatchNorm's ``num_batches_tracked``
    counters, which flax does not keep, are set to 0)."""
    sd = dict(sd)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    model.load_state_dict(sd, strict=True)


def load_npz(model: nn.Module, path: str) -> None:
    """``load_state_dict(model, state_dict_from_npz(path))``."""
    load_state_dict(model, state_dict_from_npz(path))
