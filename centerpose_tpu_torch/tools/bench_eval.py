"""Evaluation-path benchmarks on the card, counterpart of
``tools/bench_eval.py``:

1. ``bench_msflip_eval``: hrnet_w32 in bf16 with flip and scales 0.75,
   1.0, 1.25 through ``eval/harness.evaluate_detector``, serial against
   pipelined: images/s and the summed stage times;
2. ``bench_video``: mobilenetv3 in bf16, ``Detector.run_batch`` at batch 8
   over seeded uint8 frames.

Both upload from the host, so each row carries ``h2d_GBps``, the
host-to-device rate from pinned memory measured beside it, and
``h2d_bytes_per_image``.  Rows merge into the same table as
``tools/bench_suite.py`` (``--json``, default
``port_output/bench_table.json``, and its markdown):

    python -m centerpose_tpu_torch.tools.bench_eval [--images 48] [--frames 200]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from centerpose_tpu_torch.config import load_config
from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
from centerpose_tpu_torch.eval.harness import evaluate_detector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools.bench_suite import (DEFAULT_JSON, card,
                                                    merge_rows, read_table,
                                                    write_table)
from centerpose_tpu_torch.tools.evaluate import no_tf32
from centerpose_tpu_torch.utils.platform import resolve_device


def h2d_GBps(device: str = "cuda", reps: int = 3,
             mb: int = 64) -> Optional[float]:
    """Host-to-device copy rate from pinned host memory, GB/s, the best of
    ``reps`` copies of ``mb`` MiB; None on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    src = torch.empty(mb << 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty_like(src, device=dev)
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(dev)
        rates.append(src.numel() / (time.perf_counter() - t0) / 1e9)
    return round(max(rates), 2)


def bench_msflip_eval(n_images: int, device: str = "cuda",
                      opts: Sequence[str] = ()) -> List[dict]:
    """hrnet_w32 bf16 multi-scale flip evaluation over ``n_images``
    synthetic val scenes (seed 2), serial (``Detector.run``) and
    pipelined (4 pre-process threads).  ``opts``: config overrides."""
    cfg = load_config(opts=[
        "model.name", "hrnet_w32", "model.head_conv", "256",
        "model.compute_dtype", "bfloat16",
        "test.flip_test", "true",
        "test.test_scales", "0.75,1.0,1.25", *opts])
    det = Detector(cfg, device=device)
    ds = SyntheticEvalDataset(n_images, seed=2)
    ds.render()
    items = list(ds.items())
    evaluate_detector(det, items[:2], workers=2)  # warm-up
    name = card(device)
    rows = []
    for workers, label in ((0, "serial"), (4, "pipelined")):
        t0 = time.perf_counter()
        _, times, _ = evaluate_detector(det, items, workers=workers)
        dt = time.perf_counter() - t0
        row = {
            "arch": "hrnet_w32", "variant": f"bfloat16/{label}",
            "mode": "eval_msflip", "batch": 1,
            "ms_per_batch": round(dt / n_images * 1e3, 2),
            "images_per_s": round(n_images / dt, 2),
            "stage_times_s": {k: round(v, 2) for k, v in times.items()},
            "h2d_GBps": h2d_GBps(device),
            "h2d_bytes_per_image": int(items[0][1].nbytes),  # one upload
            "card": name,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def bench_video(frames: int, batch: int = 8, device: str = "cuda",
                opts: Sequence[str] = ()) -> List[dict]:
    """mobilenetv3 bf16 ``Detector.run_batch`` at ``batch`` over
    ``frames`` seeded uint8 frames of the input size."""
    cfg = load_config(opts=["model.name", "mobilenetv3",
                            "model.compute_dtype", "bfloat16", *opts])
    det = Detector(cfg, device=device)
    res = cfg.model.input_res
    rng = np.random.default_rng(0)
    stream = rng.integers(0, 255, size=(frames, res, res, 3)).astype(np.uint8)
    det.run_batch(stream[:batch])  # warm-up
    t0 = time.perf_counter()
    out = None
    for s in range(0, frames, batch):
        out = det.run_batch(stream[s:s + batch])
    dt = time.perf_counter() - t0
    assert out is not None and np.isfinite(out).all()
    row = {
        "arch": "mobilenetv3", "variant": "bfloat16", "mode": "video",
        "batch": batch,
        "ms_per_batch": round(dt / (frames // batch) * 1e3, 2),
        "images_per_s": round(frames / dt, 2),
        "h2d_GBps": h2d_GBps(device),
        "h2d_bytes_per_image": res * res * 3,
        "card": card(device),
    }
    print(json.dumps(row), flush=True)
    return [row]


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=48)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--json", default=DEFAULT_JSON)
    ap.add_argument("--skip-msflip", action="store_true")
    ap.add_argument("--skip-video", action="store_true")
    args = ap.parse_args(argv)
    no_tf32()
    rows = []
    if not args.skip_video:
        rows += bench_video(args.frames)
    if not args.skip_msflip:
        rows += bench_msflip_eval(args.images)
    table = merge_rows(read_table(args.json), rows)
    write_table(table, args.json)
    print(f"wrote {args.json} + {os.path.splitext(args.json)[0]}.md")
    return table


if __name__ == "__main__":
    main()
