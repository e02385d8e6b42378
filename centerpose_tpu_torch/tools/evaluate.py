"""Evaluation CLI, counterpart of ``tools/evaluate.py``.

With ``--synthetic``, runs the port's ``Detector`` over a synthetic val
split, one image at a time (``Detector.run``: every scale, flip and the
soft-NMS merge), and reports OKS keypoint AP:

    python -m centerpose_tpu_torch.tools.evaluate --synthetic --hard \
        --synthetic-size 512 --synthetic-seed 3 [--device cpu] \
        [--json out.json] [KEY VALUE ...]

Without ``--synthetic`` it evaluates the COCO 2017 keypoint val split
under ``dataset.root`` (``data/coco.COCOHP(cfg, "val")``) through the
pipelined harness (``eval/harness.evaluate_detector``, ``--workers``
pre-process threads decoding the image files with cv2), as the
reference does, and writes the detections to
``<output_dir>/<exp_id>/results.json`` (``run_dir``: under
``port_output`` for the default ``output_dir``, never the JAX package's
``output/``):

    python -m centerpose_tpu_torch.tools.evaluate --defaults \
        dataset.root data/coco [--limit N] [--workers 4] [KEY VALUE ...]

Without ``--cfg`` the config is the flagship's (dla_34 @512, bfloat16,
``pallas_full``), built in code; ``--defaults`` starts from the config
defaults instead (float32, ``xla``, ``head_conv`` 64), as the reference's
``load_config(None, opts)`` does, e.g. ``--defaults model.name res_18
test.model_path output/res18_hard_artifact/params_f16.npz``.
``test.model_path`` defaults to the committed dla_34 snapshot; it may
name another ``.npz`` snapshot or a checkpoint that the port's
``tools/train.py`` wrote (``<run dir>/model_best``, ``model_last``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from centerpose_tpu_torch.config import Config, flagship_config, load_config
from centerpose_tpu_torch.data.coco import COCOHP
from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
from centerpose_tpu_torch.eval.harness import evaluate_detector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.train.checkpoints import (load_checkpoint,
                                                    restore_params_filtered,
                                                    warn_impl_mismatch)
from centerpose_tpu_torch.weights import state_dict_from_npz

ROOT = Path(__file__).resolve().parents[2]
SNAPSHOT = ROOT / "output" / "dla34_hard_artifact" / "params_f16.npz"
STAGES = ("tot", "pre", "net", "post", "merge")


def run_config(path: Optional[str], opts, defaults: bool = False) -> Config:
    """The config of a run with the ``KEY VALUE`` overrides ``opts``, on
    ``path`` (a YAML file), else on the defaults where ``defaults`` is set,
    else on the flagship's."""
    if path or defaults:
        return load_config(path, list(opts or []))
    return flagship_config(list(opts or []))


def run_dir(cfg: Config) -> str:
    """``<output_dir>/<exp_id>``, where the default ``output_dir`` of
    ``output`` (the JAX package's runs) becomes ``port_output``."""
    out = cfg.output_dir
    if os.path.normpath(out) == "output":
        out = "port_output"
    return os.path.join(out, cfg.exp_id)


def checkpoint_state_dict(cfg: Config, path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``cfg`` model with the weights of a training
    checkpoint (``train/checkpoints.save_checkpoint``: ``model_best``,
    ``model_last``), as the reference's ``load_detector`` reads one: a
    warning where its ``.meta.json`` knobs differ from ``cfg``'s, the
    parameters through ``restore_params_filtered`` onto the model's seeded
    init, the BatchNorm statistics as saved."""
    warn_impl_mismatch(cfg, path)
    payload = load_checkpoint(path)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_model(cfg)
    restore_params_filtered(model, payload["model"])
    sd = model.state_dict()
    sd.update({k: v for k, v in payload["bn"].items() if k in sd})
    return sd


def load_detector(cfg: Config, device: str = "cuda") -> Detector:
    """The Detector with the weights of ``cfg.test.model_path``: an
    ``.npz`` snapshot (empty: the committed dla_34 snapshot) or a
    training checkpoint (``checkpoint_state_dict``)."""
    path = cfg.test.model_path or str(SNAPSHOT)
    if path.endswith(".npz"):
        return Detector(cfg, state_dict_from_npz(path), device=device)
    return Detector(cfg, checkpoint_state_dict(cfg, path), device=device)


def evaluate(detector: Detector, dataset: SyntheticEvalDataset,
             limit: int = 0, progress: Optional[Callable[[int], None]] = None):
    """``detector.run`` on each image of ``dataset`` (the first ``limit``
    when given); returns (results by image id, summed stage times in
    seconds, wall seconds)."""
    n = min(len(dataset), limit) if limit else len(dataset)
    times = dict.fromkeys(STAGES, 0.0)
    results: Dict[int, Dict[int, np.ndarray]] = {}
    t0 = time.perf_counter()
    for k, (img_id, img) in enumerate(dataset.items()):
        if k >= n:
            break
        ret = detector.run(img)
        results[img_id] = ret["results"]
        for key in STAGES:
            times[key] += ret[key]
        if progress:
            progress(k + 1)
    return results, times, time.perf_counter() - t0


def print_progress(n: int, every: int = 50) -> Callable[[int], None]:
    """A ``progress`` callback that prints ``[done/n]`` every ``every``
    images."""
    def progress(done: int) -> None:
        if done % every == 0:
            print(f"[{done}/{n}]", flush=True)
    return progress


def no_tf32() -> None:
    """float32 rows compute in float32 on the card too: TF32 off in cuDNN
    convolutions and matmuls (PyTorch lets cuDNN use it by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def device_name(device: str) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def payload(stats: Dict[str, float], n: int, times: Dict[str, float],
            wall: float, cfg: Config, hard: bool, device: str) -> dict:
    """The reference's result JSON: stats, throughput, ms per image per
    stage; plus the device it ran on."""
    return {
        "stats": {k: round(float(v), 4) for k, v in stats.items()},
        "n_images": n,
        "wall_s": round(wall, 1),
        "img_per_s": round(n / wall, 2),
        "ms_per_img": {k: round(1000 * times[k] / n, 1) for k in times},
        "hard": bool(hard),
        "model_path": cfg.test.model_path or str(SNAPSHOT.relative_to(ROOT)),
        "device": device_name(device),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch evaluation")
    p.add_argument("--cfg", type=str, default=None,
                   help="experiment yaml (default: the flagship, in code)")
    p.add_argument("--defaults", action="store_true",
                   help="without --cfg: start from the config defaults, "
                        "not the flagship")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--synthetic-seed", type=int, default=2,
                   help="scene seed (1: train scenes, 2: the AP-gating val "
                        "split, 3: the hard benchmark)")
    p.add_argument("--hard", action="store_true",
                   help="hard synthetic distribution (non-saturating)")
    p.add_argument("--limit", type=int, default=0, help="evaluate first N images")
    p.add_argument("--workers", type=int, default=4,
                   help="COCO files: the harness's pre-process threads "
                        "(0: the serial Detector.run loop)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--json", type=str, default="",
                   help="also write {stats, timing} to this path")
    p.add_argument("opts", nargs="*")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    """Evaluate; returns the stats."""
    args = parse_args(argv)
    no_tf32()
    cfg = run_config(args.cfg, args.opts, args.defaults)
    detector = load_detector(cfg, args.device)
    if args.synthetic:
        dataset = SyntheticEvalDataset(args.synthetic_size,
                                       seed=args.synthetic_seed,
                                       hard=args.hard)
        n = min(len(dataset), args.limit) if args.limit else len(dataset)
        results, times, wall = evaluate(detector, dataset, n,
                                        print_progress(n))
        stats = dataset.run_eval(results, img_ids=list(results))
    else:
        dataset = COCOHP(cfg, "val")
        n = min(len(dataset), args.limit) if args.limit else len(dataset)
        items = itertools.islice(dataset.items(), n)
        results, times, wall = evaluate_detector(
            detector, items, workers=args.workers,
            progress=print_progress(n))
        stats = dataset.run_eval(results, save_dir=run_dir(cfg),
                                 img_ids=list(results) if args.limit
                                 else None)
    print(f"\nimages: {n}  wall: {wall:.1f}s  ({n / wall:.2f} img/s, "
          f"{device_name(args.device)})")
    for k in STAGES:
        print(f"  {k}: {1000 * times[k] / n:.1f} ms/img")
    print("\nCOCO-protocol AP:")
    for k, v in stats.items():
        print(f"  {k:10s} {v:.4f}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload(stats, n, times, wall, cfg, args.hard,
                              args.device), f, indent=1)
    return stats


if __name__ == "__main__":
    main()
