"""Hard-benchmark evaluation tool, counterpart of ``tools/hard_eval.py``.

Evaluates snapshots on the hard synthetic benchmark (512 scenes of
``render_scene_hard``, seed 3), in this process, and writes one JSON laid
out as the reference's ``output/hard_eval.json``:

- ``flagship.modes``: the TTA ladder single -> flip -> multi-scale + flip +
  soft-NMS (``FLAGSHIP_MODES``, on the flagship config);
- ``flagship.cross_impl``: the same weights through the DCN site policies
  and dtypes of ``CROSS_IMPL``;
- ``backbones.{name}``: each ``--backbone name=path/to/params_f16.npz`` at
  single scale on the defaults with ``model.name`` set (float32, ``xla``,
  ``head_conv`` 64), as the reference's ``--backbone`` rows ran.

    python -m centerpose_tpu_torch.tools.hard_eval [--device cpu] \\
        [--rows xla_f32,single] [--n 512] [--json port_output/hard_eval.json]
    python -m centerpose_tpu_torch.tools.hard_eval \\
        --backbone res_18=output/res18_hard_artifact/params_f16.npz

Rows already in the JSON (same ``--n``) are kept and not run again.  With
``--backbone`` the flagship rows run only where ``--rows`` names them.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict, List

from centerpose_tpu_torch.config import Config, flagship_config, load_config
from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
from centerpose_tpu_torch.tools.evaluate import (ROOT, SNAPSHOT, evaluate,
                                                 load_detector, no_tf32,
                                                 payload, print_progress)

FLAGSHIP_MODES = {
    "single": [],
    "flip": ["test.flip_test", "true"],
    "ms_flip_nms": ["test.flip_test", "true",
                    "test.test_scales", "[0.75,1.0,1.25]"],
}

CROSS_IMPL = {
    "pallas_full_bf16": ["model.dcn_impl", "pallas_full",
                         "model.compute_dtype", "bfloat16"],
    "xla_bf16": ["model.dcn_impl", "xla", "model.compute_dtype", "bfloat16"],
    "xla_f32": ["model.dcn_impl", "xla", "model.compute_dtype", "float32"],
    "pallas_full_f32": ["model.dcn_impl", "pallas_full",
                        "model.compute_dtype", "float32"],
}

# per-backbone rows are single scale, whatever a yaml would ship
BACKBONE_OPTS = ["test.flip_test", "false", "test.test_scales", "[1.0]"]

SEED = 3  # held out: train scenes use seed 1, the AP-gating val split 2


def hard_dataset(n: int = 512, render_workers: int = 0) -> SyntheticEvalDataset:
    """The benchmark's scenes, rendered once."""
    ds = SyntheticEvalDataset(n, seed=SEED, hard=True)
    ds.render(render_workers)
    return ds


def backbone_config(name: str, path: str) -> Config:
    """A per-backbone row's config: the defaults, ``model.name``, single
    scale, the snapshot at ``path``."""
    return load_config(None, BACKBONE_OPTS + ["model.name", name,
                                              "test.model_path", path])


def evaluate_row(dataset: SyntheticEvalDataset, cfg: Config, opts: List[str],
                 device: str = "cuda") -> dict:
    """Every image of ``dataset`` through ``Detector.run`` on ``cfg``, OKS
    AP; the reference's payload with ``cmd_opts``."""
    detector = load_detector(cfg, device)
    results, times, wall = evaluate(detector, dataset,
                                    progress=print_progress(len(dataset)))
    stats = dataset.run_eval(results, img_ids=list(results))
    out = payload(stats, len(results), times, wall, cfg, True, device)
    out["cmd_opts"] = list(opts)
    return out


def run_row(dataset: SyntheticEvalDataset, opts: List[str],
            device: str = "cuda", model_path: str = "") -> dict:
    """One flagship row: the flagship config with ``opts``."""
    cfg = flagship_config(list(opts) + ["test.model_path", model_path])
    return evaluate_row(dataset, cfg, opts, device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=512, help="benchmark size")
    p.add_argument("--flagship", default="",
                   help="flagship .npz snapshot (default: the committed "
                        "dla_34 snapshot)")
    p.add_argument("--rows", default="",
                   help="comma-separated rows to run (default: all of "
                        + ", ".join([*FLAGSHIP_MODES, *CROSS_IMPL]) + ")")
    p.add_argument("--backbone", action="append", default=[],
                   metavar="NAME=NPZ",
                   help="a per-backbone row (repeatable), e.g. "
                        "res_18=output/res18_hard_artifact/params_f16.npz")
    p.add_argument("--device", default="cuda")
    p.add_argument("--render-workers", type=int, default=0,
                   help="processes that draw the scenes (0: this one)")
    p.add_argument("--json", default=str(Path("port_output")
                                         / "hard_eval.json"))
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    no_tf32()
    plans = {"modes": FLAGSHIP_MODES, "cross_impl": CROSS_IMPL}
    wanted = [r for r in args.rows.split(",") if r]
    backbones = dict(spec.partition("=")[::2] for spec in args.backbone)
    if any(not path for path in backbones.values()):
        raise SystemExit(f"--backbone takes NAME=NPZ: {args.backbone}")
    known = [name for plan in plans.values() for name in plan]
    unknown = sorted(set(wanted) - set(known))
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {known}")
    out: Dict = {
        "eval_set": {
            "generator": "centerpose_tpu_torch/data/synthetic.render_scene_hard",
            "n_images": args.n,
            "seed": SEED,
        },
    }
    if os.path.exists(args.json):  # accumulate across partial runs
        with open(args.json) as f:
            prev = json.load(f)
        if prev.get("eval_set", {}).get("n_images") == args.n:
            out = prev

    def save():
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)

    dataset = None

    def scenes() -> SyntheticEvalDataset:
        nonlocal dataset
        if dataset is None:
            dataset = hard_dataset(args.n, args.render_workers)
        return dataset

    ckpt = args.flagship or str(SNAPSHOT.relative_to(ROOT))
    fl = out.setdefault("flagship", {"arch": "dla_34", "ckpt": ckpt})
    for plan_name, plan in plans.items():
        rows = fl.setdefault(plan_name, {})
        for name, opts in plan.items():
            if name in rows or ((wanted or backbones)
                                and name not in wanted):
                continue
            print(f"== flagship {plan_name} {name}", flush=True)
            rows[name] = run_row(scenes(), opts, args.device, args.flagship)
            save()
            print(json.dumps(rows[name]["stats"]), flush=True)
    bb = out.setdefault("backbones", {})
    for name, path in backbones.items():
        if name in bb:
            continue
        print(f"== backbone {name}", flush=True)
        bb[name] = evaluate_row(scenes(), backbone_config(name, path),
                                BACKBONE_OPTS, args.device)
        save()
        print(json.dumps(bb[name]["stats"]), flush=True)
    save()
    print("wrote", args.json)


if __name__ == "__main__":
    main()
