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
- ``restore_params_filtered``: the reference's ``load_model`` semantics
  (a missing or mis-shaped parameter keeps its init, an unexpected one is
  dropped, each with its line).
- ``import_state_dict`` with ``torchvision_resnet_key_maps`` or
  ``dla34_pose_key_maps``: an upstream (PyTorch-layout) state dict merged
  into the model as the reference's ``import_numpy_state_dict`` merges it
  into its tree; whatever finds no target keeps its init.

Lines name a parameter by the reference's spelling of its key
(``['base']['base_layer']['Conv_0']['kernel']``) and shapes in the
reference's layout, so they read as the reference's.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from centerpose_tpu_torch.ops.dcn_cuda import DEFAULT_MAX_DY
from centerpose_tpu_torch.weights import (load_npz, npz_arrays, port_layout,
                                         reference_shape, torch_key)

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


def model_npz_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
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
    by_key = model_npz_tensors(model)
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


# ---------------------------------------------------------------------------
# Filtered restore and upstream import
# ---------------------------------------------------------------------------
_PATH = re.compile(r"\['([^']+)'\]")
_REF_LEAF = {"weight": "kernel", "running_mean": "mean", "running_var": "var"}


def _ref_spelling(name: str, by_name: Dict[str, str]) -> str:
    """The reference's spelling of the key of state-dict name ``name``
    (``by_name``: the model's {name: snapshot key}); a name the model does
    not have is spelled by its parts, ``weight`` as ``kernel``."""
    if name in by_name:
        return by_name[name].partition(":")[2]
    *path, leaf = name.split(".")
    return "".join(f"['{p}']" for p in [*path, _REF_LEAF.get(leaf, leaf)])


def _numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        return (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
    return np.asarray(arr)


@torch.no_grad()
def restore_params_filtered(model: torch.nn.Module,
                            state_dict: Dict[str, Any],
                            verbose: bool = True) -> torch.nn.Module:
    """Copy the parameters of ``state_dict`` (by the port's names, e.g. a
    checkpoint's ``model`` group) into ``model``'s: a parameter missing
    from it, or there in another shape, keeps its init; a key the model
    has no parameter for is dropped; each is printed when ``verbose``.
    Returns ``model``."""
    tensors = {k: t for k, t in model_npz_tensors(model).items()
               if k.startswith("params:")}
    by_name = {torch_key(k): k for k in tensors}
    for name, key in by_name.items():
        t, ref = tensors[key], key.partition(":")[2]
        if name not in state_dict:
            if verbose:
                print(f"[ckpt] missing in checkpoint, keeping init: {ref}")
        elif tuple(state_dict[name].shape) != tuple(t.shape):
            if verbose:
                print(f"[ckpt] shape mismatch for {ref}: ckpt "
                      f"{reference_shape(key, state_dict[name].shape)} vs "
                      f"model {reference_shape(key, t.shape)}; skipping")
        else:
            t.copy_(torch.as_tensor(state_dict[name]))
    for name in state_dict:
        if name not in by_name and verbose:
            print("[ckpt] unexpected key in checkpoint, dropped: "
                  f"{_ref_spelling(name, by_name)}")
    return model


def _to_reference_layout(arr: np.ndarray, shape: tuple) -> np.ndarray:
    """An upstream tensor in the reference's layout of ``shape``, as its
    ``_torch_to_flax_layout`` converts it: as it is where the shape
    matches, conv kernels OIHW -> HWIO and linear [out, in] -> [in, out]
    where that matches; otherwise unchanged (a mismatch)."""
    if arr.shape == shape:
        return arr
    if arr.ndim == 4 and arr.transpose(2, 3, 1, 0).shape == shape:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2 and arr.T.shape == shape:
        return arr.T
    return arr


@torch.no_grad()
def import_state_dict(model: torch.nn.Module, state_dict: Dict[str, Any],
                      key_map: Optional[Dict[str, str]] = None,
                      verbose: bool = True) -> torch.nn.Module:
    """Merge a PyTorch-convention state dict (numpy arrays or tensors)
    into ``model``'s parameters and BatchNorm statistics.

    A key is a name of the port's state dict, or any name that ``key_map``
    ({state_dict key: port name}) routes to one.  Each array is brought to
    its target's layout through the reference's (``_to_reference_layout``
    against the reference's shape of the target, then
    ``weights.port_layout``): upstream OIHW conv kernels land on the port's
    OIHW convs as they are and on its DCN weights ([3, 3, Cin, Cout])
    transposed.  Anything unmatched keeps its init, printed when
    ``verbose`` with the count loaded.  Returns ``model``."""
    tensors = model_npz_tensors(model)
    by_name = {torch_key(k): k for k in tensors}
    loaded = set()
    for key, arr in state_dict.items():
        name = key_map.get(key, key) if key_map else key
        if name not in by_name:
            if verbose:
                print(f"[import] no model param for {key}; dropped")
            continue
        npz_key = by_name[name]
        t = tensors[npz_key]
        want = reference_shape(npz_key, t.shape)
        arr = _to_reference_layout(_numpy(arr), want)
        if arr.shape != want:
            if verbose:
                print(f"[import] shape mismatch for "
                      f"{npz_key.partition(':')[2]}: {arr.shape} vs {want}; "
                      "skipping")
            continue
        t.copy_(torch.from_numpy(np.ascontiguousarray(
            port_layout(npz_key, arr))))
        loaded.add(npz_key)
    if verbose:
        print(f"[import] loaded {len(loaded)}/{len(tensors)} params")
    return model


# torchvision ResNet: ``layerL.i`` is the port's ``{BasicBlock|Bottleneck}_k``
# in construction order, ``convN``/``bnN`` its ``ConvBN_{N-1}``,
# ``downsample.{0,1}`` its trailing projection.  The deconvs and heads have
# no torchvision source and keep their init.
_RESNET_TV_LAYERS = {
    18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
    101: (3, 4, 23, 3), 152: (3, 8, 36, 3),
}


def torchvision_resnet_key_maps(num_layers: int) -> Dict[str, str]:
    """{torchvision ``resnet{num_layers}`` name: the port's PoseResNet
    name} for ``import_state_dict``, parameters and statistics."""
    layers = _RESNET_TV_LAYERS[num_layers]
    n_convs = 3 if num_layers >= 50 else 2
    prefix = "Bottleneck" if num_layers >= 50 else "BasicBlock"
    out = {"conv1.weight": "Conv_0.weight", "bn1.weight": "BatchNorm_0.weight",
           "bn1.bias": "BatchNorm_0.bias",
           "bn1.running_mean": "BatchNorm_0.running_mean",
           "bn1.running_var": "BatchNorm_0.running_var"}

    def bn(src: str, dst: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{src}.{leaf}"] = f"{dst}.BatchNorm_0.{leaf}"

    blk = 0
    for stage, n in enumerate(layers, start=1):
        for i in range(n):
            t, f = f"layer{stage}.{i}", f"{prefix}_{blk}"
            for c in range(n_convs):
                out[f"{t}.conv{c + 1}.weight"] = f"{f}.ConvBN_{c}.Conv_0.weight"
                bn(f"{t}.bn{c + 1}", f"{f}.ConvBN_{c}")
            ds = f"{f}.ConvBN_{n_convs}"
            out[f"{t}.downsample.0.weight"] = f"{ds}.Conv_0.weight"
            bn(f"{t}.downsample.1", ds)
            blk += 1
    return out


def _dla34_torch_name(parts) -> Optional[str]:
    """The upstream ``pose_dla_dcn.DLASeg`` name of one reference key path
    (its segments, leaf included); None where there is none.  Upstream:
    ``base.base_layer.{0,1}``, ``base.levelK[.tree1/.tree2/.root/.project]``
    (BasicBlock ``conv1/bn1/conv2/bn2``, Root ``conv/bn``,
    ``project.{0,1}``), ``dla_up.ida_I.{proj,node}_K.conv{.weight,.bias,
    .conv_offset_mask.*}`` with ``.actf.0`` (the BatchNorm), ``ida_up.*``
    likewise, ``{head}.{0,2}`` (Sequential(conv3x3, relu, conv1x1))."""
    leaf = parts[-1]
    segs = parts[:-1]
    conv_leaf = {"kernel": "weight", "bias": "bias"}
    bn_leaf = {"scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}
    out: list = []
    i = 0
    while i < len(segs):
        s = segs[i]
        if s.startswith("HeadStack"):
            i += 1  # a container with no upstream counterpart
        elif s in ("base", "dla_up", "ida_up") or s.startswith(
                ("level", "tree", "ida_", "proj_", "node_")):
            out.append(s)
            i += 1
        elif s == "base_layer":
            if segs[i + 1] == "Conv_0":
                return ".".join(out + [s, "0", conv_leaf[leaf]])
            return ".".join(out + [s, "1", bn_leaf[leaf]])
        elif s == "root":
            if segs[i + 2] == "Conv_0":  # root/ConvBN_0/{Conv_0,BatchNorm_0}
                return ".".join(out + ["root", "conv", conv_leaf[leaf]])
            return ".".join(out + ["root", "bn", bn_leaf[leaf]])
        elif s == "project":
            if segs[i + 1] == "Conv_0":
                return ".".join(out + ["project", "0", conv_leaf[leaf]])
            return ".".join(out + ["project", "1", bn_leaf[leaf]])
        elif s.startswith("ConvBN_"):
            # a BasicBlock's conv1/bn1, conv2/bn2
            n = int(s.split("_")[1]) + 1
            if segs[i + 1] == "Conv_0":
                return ".".join(out + [f"conv{n}", conv_leaf[leaf]])
            return ".".join(out + [f"bn{n}", bn_leaf[leaf]])
        elif s == "Conv_0":
            # a ConvBN named by its parent (level0, level1): Sequential
            return ".".join(out + ["0", conv_leaf[leaf]])
        elif s == "BatchNorm_0" and segs[i - 1].startswith("level"):
            return ".".join(out + ["1", bn_leaf[leaf]])
        elif s == "DCN_0":
            if i + 1 < len(segs) and segs[i + 1] == "conv_offset_mask":
                return ".".join(out + ["conv", "conv_offset_mask",
                                       conv_leaf[leaf]])
            return ".".join(out + ["conv", conv_leaf[leaf]])
        elif s == "BatchNorm_0":
            # DeformConv's BatchNorm -> actf.0
            return ".".join(out + ["actf", "0", bn_leaf[leaf]])
        elif s.endswith("_conv"):
            return ".".join([s[:-5], "0", conv_leaf[leaf]])
        elif s.endswith("_out"):
            return ".".join([s[:-4], "2", conv_leaf[leaf]])
        else:
            return None
    return None


def dla34_pose_key_maps(model: torch.nn.Module) -> Dict[str, str]:
    """{upstream ``pose_dla_dcn`` name: the port's name} for a dla_34
    model's parameters and statistics, by walking the live module.  The
    frozen bilinear ``up_K`` transposed-conv weights of upstream have no
    target (the port's upsample is fixed math) and are dropped by
    ``import_state_dict``."""
    out = {}
    for key in model_npz_tensors(model):
        name = _dla34_torch_name(_PATH.findall(key.partition(":")[2]))
        if name is not None:
            out[name] = torch_key(key)
    return out
