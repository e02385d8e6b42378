"""Checkpoints: save, resume, the semantic-knob sidecar and npz snapshots.

Counterpart of ``centerpose_tpu/train/checkpoints.py`` (orbax there,
``torch.save`` here):

- ``save_checkpoint`` writes ``{step, epoch, model, bn, optimizer}`` (the
  ``Trainer.state`` layout).  The device-to-host copy happens in the call;
  the file is written on a background thread, to a temporary file that is
  then renamed, so an epoch-boundary save does not stall the device and a
  reader never sees half a file.  ``wait_for_saves`` waits for it.
- ``ckpt_meta`` / ``warn_impl_mismatch``: the ``<path>.meta.json`` sidecar
  with the DCN knobs the weights were trained under and the resolved
  per-site clamp table, and the reference's warnings when an eval config
  differs from them.
- ``load_checkpoint`` / ``restore_state``: a full resume, refused (never
  done quietly) when the optimizer's state does not match the live one in
  count or shapes.
- ``save_params_npz`` / ``load_params_npz``: the reference's flat-key
  snapshot format (``params:['a']['b']['kernel']``,
  ``batch_stats:[...]['mean']``), so snapshots go both ways between the
  packages.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from centerpose_tpu_torch.ops.dcn_cuda import DEFAULT_MAX_DY
from centerpose_tpu_torch.weights import load_npz, npz_arrays, torch_key

_SAVES: List[threading.Thread] = []
_ERRORS: List[BaseException] = []


def to_host(obj: Any) -> Any:
    """A deep copy of ``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _write(payload: dict, path: str, meta: Optional[Dict[str, Any]]) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if meta is not None:
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f, indent=1)
    except BaseException as e:  # raised by the next wait_for_saves
        _ERRORS.append(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, trainer, epoch: int = 0,
                    async_save: bool = True,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``{step, epoch, model, bn, optimizer}`` of ``trainer`` to
    ``path``.

    The state is copied to the host now; with ``async_save`` the file is
    written on a background thread (after any earlier save has landed).
    ``meta`` (JSON-serialisable, typically ``ckpt_meta(cfg)``) goes to
    ``<path>.meta.json`` once the checkpoint is in place.  A stale sidecar
    is removed first: a failed save must not leave an earlier run's sidecar
    describing weights that were never written."""
    path = os.path.abspath(path)
    payload = {"epoch": int(epoch), **to_host(trainer.state())}
    wait_for_saves()  # an earlier save may still write this sidecar
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        os.remove(meta_path)
    if not async_save:
        _write(payload, path, meta)
        wait_for_saves()
        return
    t = threading.Thread(target=_write, args=(payload, path, meta))
    t.start()
    _SAVES.append(t)


def wait_for_saves() -> None:
    """Block until every background save has landed; raise the first
    error one of them met."""
    while _SAVES:
        _SAVES.pop(0).join()
    if _ERRORS:
        err = _ERRORS.pop(0)
        _ERRORS.clear()
        raise err


def ckpt_meta(cfg) -> Dict[str, Any]:
    """The semantic knobs recorded beside every checkpoint, with the
    resolved per-width clamp table (``ops/dcn_cuda.DEFAULT_MAX_DY``): a
    checkpoint trained with ``dcn_max_dy`` 0 depends on that table's
    values at train time."""
    return {
        "arch": cfg.model.name,
        "dcn_impl": cfg.model.dcn_impl,
        "dcn_max_dy": cfg.model.dcn_max_dy,
        "compute_dtype": cfg.model.compute_dtype,
        "input_res": cfg.model.input_res,
        "dcn_default_max_dy": {str(k): v for k, v in DEFAULT_MAX_DY.items()},
    }


def warn_impl_mismatch(cfg, path: str) -> Optional[str]:
    """Compare an eval config's DCN knobs with a checkpoint's sidecar;
    return (and print) a warning on a mismatch, None otherwise.

    Under ``pallas``/``pallas_full`` the sites clamp their y-offsets, under
    ``xla`` they do not: evaluating a checkpoint under another policy than
    it was trained with evaluates another function."""
    meta_path = os.path.abspath(path) + ".meta.json"
    have_impl = getattr(cfg.model, "dcn_impl", None)
    if not os.path.exists(meta_path):
        if have_impl in ("pallas", "pallas_full"):
            msg = (
                f"[ckpt] WARNING: {path} has no .meta.json sidecar; this "
                "pallas eval uses the CURRENT per-site clamp table "
                "(DEFAULT_MAX_DY), which may differ from the table the "
                "checkpoint was trained under.  Pre-r4 pallas checkpoints "
                "were trained with a uniform +/-4 clamp — set "
                "model.dcn_max_dy 4 to reproduce them (docs/DCN.md)."
            )
            print(msg, flush=True)
            return msg
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    mismatches = []
    notes = []

    def fwd_family(impl):
        # pallas and pallas_full share the forward (they differ only in
        # which backward runs): not a mismatch at eval
        return "pallas" if impl in ("pallas", "pallas_full") else impl

    want_impl = meta.get("dcn_impl")
    if want_impl is not None and fwd_family(want_impl) != fwd_family(have_impl):
        mismatches.append(f"dcn_impl: trained={want_impl!r} eval={have_impl!r}")
    want = meta.get("dcn_max_dy")
    have = getattr(cfg.model, "dcn_max_dy", None)
    if want is not None and want != have:
        mismatches.append(f"dcn_max_dy: trained={want!r} eval={have!r}")
    want_tbl = meta.get("dcn_default_max_dy")
    if want_tbl is not None and meta.get("dcn_max_dy", 0) == 0:
        have_tbl = {str(k): v for k, v in DEFAULT_MAX_DY.items()}
        if want_tbl != have_tbl:
            mismatches.append(
                f"auto-clamp table: trained={want_tbl} current={have_tbl}")
    for knob in ("compute_dtype", "input_res"):
        want_v = meta.get(knob)
        have_v = getattr(cfg.model, knob, None)
        if want_v is not None and want_v != have_v:
            notes.append(f"{knob}: trained={want_v!r} eval={have_v!r}")
    if not mismatches:
        if notes:
            print(f"[ckpt] note: {path} eval knobs differ from train time "
                  f"({'; '.join(notes)}) — numerics may shift slightly.",
                  flush=True)
        return None
    msg = (
        f"[ckpt] WARNING: {path} was trained with different DCN semantics "
        f"than this eval config ({'; '.join(mismatches + notes)}).  The "
        "pallas kernels' y-clamp makes dcn_impl part of the model function "
        "— evaluate with the training impl or expect an AP gap "
        "(docs/DCN.md)."
    )
    print(msg, flush=True)
    return msg


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a ``save_checkpoint`` file, on the CPU (waits for
    background saves first)."""
    wait_for_saves()
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def restore_state(trainer, payload: Dict[str, Any]):
    """Full resume of ``trainer`` (step, parameters, BatchNorm statistics,
    optimizer state and schedule position) from a payload; returns it.

    The saved state is hung on the live trainer only if it has the same
    structure: the same parameter and buffer names and shapes, and for each
    parameter the optimizer state the live optimizer keeps (its names and
    shapes: Adam's step and two moments, SGD's momentum).  Anything else
    raises: an optimizer changed between save and resume would otherwise
    resume quietly with a corrupt state."""
    live = trainer.state()
    for group in ("model", "bn"):
        want = {k: tuple(v.shape) for k, v in live[group].items()}
        got = {k: tuple(v.shape) for k, v in payload[group].items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))[:4]
            raise ValueError(f"{group} mismatch between checkpoint and model "
                             f"(first differences: {diff})")
    opt = trainer.optimizer
    saved = payload["optimizer"]["opt"]
    n_saved = sum(len(g["params"]) for g in saved["param_groups"])
    if n_saved != len(opt.params):
        raise ValueError(f"opt_state mismatch: checkpoint covers {n_saved} "
                         f"parameters, optimizer {len(opt.params)}")
    for i, p in enumerate(opt.params):
        got = {k: tuple(v.shape) for k, v in saved["state"].get(i, {}).items()
               if isinstance(v, torch.Tensor)}
        want = opt.state_shapes(p)
        if got and got != want:
            raise ValueError(
                f"opt_state mismatch at parameter {i}: checkpoint {got}, "
                f"optimizer expects {want} — was the optimizer config "
                "changed between save and resume?")
    trainer.load_state(payload)
    return trainer


def _npz_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and BatchNorm statistics by the reference's
    flat key (the fixed upsample kernels and BatchNorm's batch counters
    have none)."""
    out = {}
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        *path, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            group, leaf = "batch_stats", leaf[len("running_"):]
        elif isinstance(t, torch.nn.Parameter):
            group = "params"
            if leaf == "weight":
                bn = isinstance(model.get_submodule(".".join(path)),
                                torch.nn.BatchNorm2d)
                leaf = "scale" if bn else "kernel"
        else:
            continue
        key = f"{group}:" + "".join(f"['{p}']" for p in [*path, leaf])
        if torch_key(key) != name:
            raise KeyError(f"{name} has no flat key ({key} maps elsewhere)")
        out[key] = t
    return out


def save_params_npz(model: torch.nn.Module, path: str, dtype=None) -> None:
    """A flat-key ``.npz`` snapshot of the model's parameters and BatchNorm
    statistics in the reference's format and layouts (params optionally
    cast to ``dtype``), readable by its ``load_params_npz``."""
    by_key = _npz_tensors(model)
    flat = npz_arrays({torch_key(k): t for k, t in by_key.items()}, by_key)
    if dtype is not None:
        flat = {k: (v.astype(dtype) if k.startswith("params:") else v)
                for k, v in flat.items()}
    np.savez_compressed(path, **flat)


def load_params_npz(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a ``save_params_npz`` snapshot (either package's) into
    ``model`` strictly; returns it."""
    load_npz(model, path)
    return model
