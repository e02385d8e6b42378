"""Check the upstream state-dict importer at full pose-net scale,
counterpart of ``tools/check_importer.py``.

    python -m centerpose_tpu_torch.tools.check_importer [--device cpu] \
        [--json port_output/importer_coverage.json]

Synthesises an upstream-named ``pose_dla_dcn`` DLA-34 state dict
(``head_conv`` 256) from a seeded port model: OIHW conv layouts, the DCN
``conv.conv_offset_mask`` keys, the DLAUp/IDAUp module paths, Sequential
heads and the frozen ``up_K`` transposed-conv weights, which have no target
(the port's upsample is fixed math) and are reported dropped.  It runs the
dict through ``train/checkpoints.import_state_dict`` with
``dla34_pose_key_maps``, prints the coverage per parameter and statistic
as JSON (and writes it to ``--json``), and runs one forward of the
imported model on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.train.checkpoints import (dla34_pose_key_maps,
                                                    import_state_dict,
                                                    model_npz_tensors)
from centerpose_tpu_torch.utils.platform import resolve_device
from centerpose_tpu_torch.weights import reference_shape, torch_key

# upstream tensors with no counterpart in the port: the frozen bilinear
# up_K ConvTranspose weights
EXTRAS = ["dla_up.ida_0.up_1.weight", "ida_up.up_1.weight",
          "ida_up.up_2.weight"]


def upstream_shape(npz_key: str, shape) -> tuple:
    """The upstream (PyTorch) shape of a port tensor: conv kernels OIHW."""
    shape = reference_shape(npz_key, shape)
    if len(shape) == 4:  # HWIO -> OIHW
        kh, kw, ci, co = shape
        return (co, ci, kh, kw)
    return shape


def upstream_state_dict(model: torch.nn.Module, key_map: Dict[str, str],
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded float32 arrays under the upstream names of ``key_map``
    ({upstream name: port name}) whose target ``model`` has, in the
    upstream shapes of those targets, plus ``EXTRAS``: conv weights at
    scale 0.05 and vectors at 0.2 (the deep net stays finite), running
    variances positive."""
    tensors = {torch_key(k): (k, t)
               for k, t in model_npz_tensors(model).items()}
    rng = np.random.default_rng(seed)
    state_dict = {}
    for up, name in key_map.items():
        if name not in tensors:
            continue
        npz_key, t = tensors[name]
        shape = upstream_shape(npz_key, t.shape)
        if npz_key.startswith("batch_stats:"):
            arr = rng.normal(size=shape).astype(np.float32)
            state_dict[up] = np.abs(arr) if up.endswith("running_var") else arr
        else:
            scale = 0.05 if len(shape) == 4 else 0.2
            state_dict[up] = (rng.normal(size=shape) * scale).astype(np.float32)
    for e in EXTRAS:
        state_dict[e] = rng.normal(size=(64, 64, 4, 4)).astype(np.float32)
    return state_dict


def build_fixture_and_import(seed: int = 0, input_res: int = 256):
    """(coverage report, config, the imported model on the CPU)."""
    cfg = update_config(default_config(), {"model": {
        "name": "dla_34", "head_conv": 256, "input_res": input_res,
        "output_res": input_res // 4}})
    torch.manual_seed(seed)
    model = create_model(cfg)
    key_map = dla34_pose_key_maps(model)
    tensors = {torch_key(k): (k, t)
               for k, t in model_npz_tensors(model).items()}
    init = {name: t.detach().clone() for name, (_, t) in tensors.items()}
    state_dict = upstream_state_dict(model, key_map, seed)
    import_state_dict(model, state_dict, key_map=key_map, verbose=False)

    def is_stat(name: str) -> bool:
        return tensors[name][0].startswith("batch_stats:")

    mapped = set(key_map.values())
    changed = {name for name, (_, t) in tensors.items()
               if not torch.equal(t, init[name])}
    params = [n for n in tensors if not is_stat(n)]
    stats = [n for n in tensors if is_stat(n)]
    report = {
        "n_params": len(params),
        "n_stats": len(stats),
        "n_mapped_params": sum(1 for n in mapped if not is_stat(n)),
        "n_mapped_stats": sum(1 for n in mapped if is_stat(n)),
        "n_imported_params_changed": sum(1 for n in params if n in changed),
        "n_imported_stats_changed": sum(1 for n in stats if n in changed),
        "unmapped_params": sorted(n for n in params if n not in mapped),
        "unmapped_stats": sorted(n for n in stats if n not in mapped),
        "dropped_upstream_extras": [e for e in EXTRAS if e not in key_map],
    }
    return report, cfg, model


def forward_and_report(report: dict, cfg, model: torch.nn.Module,
                       device: torch.device, json_path: str = "") -> dict:
    """One forward of the imported ``model`` on ``device`` (its heads
    finite: ``forward_ok``); prints the report and writes it to
    ``json_path`` when one is given."""
    model = model.to(device).eval()
    res = cfg.model.input_res
    with torch.no_grad():
        out = model(torch.zeros(1, res, res, 3, device=device))
    report["forward_ok"] = all(bool(torch.isfinite(v).all())
                               for v in out.values())
    print(json.dumps(report, indent=1))
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", json_path)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="",
                    help="also write the report to this path")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    report, cfg, model = build_fixture_and_import()
    return forward_and_report(report, cfg, model, device, args.json)

if __name__ == "__main__":
    main()
