"""The host input pipeline stage by stage against the card's training rate,
counterpart of ``tools/bench_input_pipeline.py``.

    python -m centerpose_tpu_torch.tools.bench_input_pipeline \\
        [--images 96] [--samples 64] \\
        [--json port_output/input_pipeline.json] [--device cpu] \\
        [KEY VALUE ...]

Stages (the flagship's dla_34 config on the defaults, then ``KEY VALUE``):

1. ``raw_render_img_s``: ``SyntheticPoseDataset.get_raw`` alone (the
   scene render), over ``--samples`` images;
2. ``encode_only_{native,python}_img_s``: ``data/encode.encode_example``
   (train augmentation) on one pre-rendered scene, with the native fill
   loop and with it swapped out for the Python loop;
3. ``loader_sweep``: ``data/loader.DataLoader.epoch`` over ``--images``
   images with 0, 1 and ``host_cpus`` spawned workers, native and Python
   encoder; each run in a subprocess whose environment sets or clears
   ``CENTERPOSE_DISABLE_NATIVE``, so that its workers see it; the pool's
   start is excluded by a warm-up batch;
4. ``prefetch_{float32,compact}``: the loader (``host_cpus - 1`` workers)
   through ``prefetch_to_device`` to the card for each wire, images/s and
   the bytes each batch and image carries to the device.

On the card the same run also times ``Trainer.train_step`` (dla_34 bf16
``pallas_full``, batch 8, the snapshot; ``tools/bench_suite.
bench_train``) as ``card_train_img_s``, and ``budget`` sets the best
loader rate against it: ``host_feeds_n_cards``, ``per_core_img_s`` and
the cores one card needs, with the card's name and power limit.  With
``--device cpu`` the prefetch goes to the CPU and the card's rate is left
out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from centerpose_tpu_torch.config import Config, load_config
from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
from centerpose_tpu_torch.utils.platform import resolve_device

DEFAULT_JSON = "port_output/input_pipeline.json"
ROOT = Path(__file__).resolve().parents[2]
LOADER_TIMEOUT = 900  # seconds for one loader run's subprocess
BATCH = 8  # images per batch, as the flagship's training step takes them

_LOADER_RUN = """
import json, sys
from centerpose_tpu_torch.tools.bench_input_pipeline import loader_rate
print(json.dumps(loader_rate(*json.loads(sys.argv[1]))))
"""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=96,
                   help="images per loader and prefetch run")
    p.add_argument("--samples", type=int, default=64,
                   help="images of the render and encode-only stages")
    p.add_argument("--json", default=DEFAULT_JSON)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    return p.parse_args(argv)


def pipeline_cfg(opts: Sequence[str] = ()) -> Config:
    return load_config(None, ["model.name", "dla_34", *opts])


def raw_render_rate(n: int) -> float:
    """Images/s of ``get_raw`` (one warm-up scene first)."""
    ds = SyntheticPoseDataset(n, seed=0)
    ds.get_raw(0)
    t0 = time.perf_counter()
    for i in range(n):
        ds.get_raw(i)
    return n / (time.perf_counter() - t0)


def encode_only_rates(n: int, opts: Sequence[str] = ()) -> Dict[str, float]:
    """``encode_example`` alone on one pre-rendered scene, with the native
    fill loop and with the Python loop (``_try_native_encode`` swapped out,
    restored after)."""
    from centerpose_tpu_torch.data import encode as enc

    cfg = pipeline_cfg(opts)
    img, anns = SyntheticPoseDataset(8, seed=0).get_raw(0)
    rng = np.random.default_rng(0)
    out = {}
    native = enc._try_native_encode
    for name, fn in (("native", native), ("python", lambda *a, **k: False)):
        enc._try_native_encode = fn
        try:
            enc.encode_example(img, anns, cfg, rng, True)
            t0 = time.perf_counter()
            for _ in range(n):
                enc.encode_example(img, anns, cfg, rng, True)
            out[f"encode_only_{name}_img_s"] = n / (time.perf_counter() - t0)
        finally:
            enc._try_native_encode = native
    return out


def loader_rate(n_images: int, workers: int, batch: int,
                opts: Sequence[str] = ()) -> Dict[str, float]:
    """Images/s of one ``DataLoader`` epoch after its first batch (the
    pool's start and its first chunk excluded)."""
    from centerpose_tpu_torch.data.loader import DataLoader

    ds = SyntheticPoseDataset(n_images, seed=0)
    dl = DataLoader(ds, pipeline_cfg(opts), batch_size=batch, is_train=True,
                    num_workers=workers, seed=0)
    try:
        it = dl.epoch(0)
        next(it)
        t0 = time.perf_counter()
        n = sum(b["input"].shape[0] for b in it)
        dt = time.perf_counter() - t0
    finally:
        dl.close()
    return {"img_s": n / dt, "n": n}


def loader_run(n_images: int, workers: int, batch: int, python: bool,
               opts: Sequence[str] = ()) -> Dict[str, float]:
    """``loader_rate`` in a subprocess whose environment sets
    ``CENTERPOSE_DISABLE_NATIVE`` (the Python encoder) or clears it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    if python:
        env["CENTERPOSE_DISABLE_NATIVE"] = "1"
    else:
        env.pop("CENTERPOSE_DISABLE_NATIVE", None)
    args = json.dumps([n_images, workers, batch, list(opts)])
    out = subprocess.run([sys.executable, "-c", _LOADER_RUN, args], env=env,
                         capture_output=True, text=True,
                         timeout=LOADER_TIMEOUT)
    if out.returncode != 0:
        raise RuntimeError(f"loader run ({workers} workers, "
                           f"{'python' if python else 'native'}) failed:\n"
                           f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def prefetch_rate(n_images: int, batch: int, wire: str, device: str,
                  opts: Sequence[str] = ()) -> Dict[str, float]:
    """Images/s of the loader through ``prefetch_to_device`` (two batches
    ahead) to ``device`` after the first batch, and the bytes of the first
    batch's tensors on the device, per batch and per image."""
    from centerpose_tpu_torch.data.loader import DataLoader, prefetch_to_device

    dev = resolve_device(device)
    cfg = pipeline_cfg([*opts, "train.wire", wire])
    ds = SyntheticPoseDataset(n_images, seed=0)
    dl = DataLoader(ds, cfg, batch_size=batch, is_train=True,
                    num_workers=max(1, (os.cpu_count() or 2) - 1), seed=0)
    try:
        it = prefetch_to_device(dl.epoch(0), dev, size=2)
        first = next(it)
        nbytes = sum(t.numel() * t.element_size() for t in first.values())
        t0 = time.perf_counter()
        n = 0
        for b in it:
            n += b["input"].shape[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    finally:
        dl.close()
    return {"prefetch_img_s": n / dt, "bytes_per_batch": nbytes,
            "bytes_per_image": nbytes // batch}


def run(images: int = 96, samples: int = 64, device: str = "cuda",
        opts: Sequence[str] = ()) -> dict:
    """Every stage (see the module docstring), each printed when done."""
    from centerpose_tpu_torch.tools.bench_suite import card

    dev = resolve_device(device)
    ncpu = os.cpu_count() or 1
    res = {"host_cpus": ncpu, "card": card(device),
           "raw_render_img_s": raw_render_rate(samples)}
    res.update(encode_only_rates(samples, opts))
    print(json.dumps(res), flush=True)
    rows = []
    for python in (False, True):
        for workers in sorted({0, 1, ncpu}):
            r = loader_run(images, workers, BATCH, python, opts)
            rows.append({"num_workers": workers,
                         "encoder": "python" if python else "native",
                         "loader_img_s": r["img_s"]})
            print(json.dumps(rows[-1]), flush=True)
    res["loader_sweep"] = rows
    for wire in ("float32", "compact"):
        res[f"prefetch_{wire}"] = prefetch_rate(images, BATCH, wire, device,
                                                opts)
        print(json.dumps({"wire": wire, **res[f"prefetch_{wire}"]}),
              flush=True)
    best = max(rows, key=lambda r: r["loader_img_s"])
    per_core = best["loader_img_s"] / max(1, min(ncpu, best["num_workers"]))
    res["budget"] = {"host_rate_img_s": best["loader_img_s"],
                     "per_core_img_s": per_core, "card": res["card"]}
    if dev.type == "cuda":
        from centerpose_tpu_torch.tools.bench_suite import bench_train, build

        cfg = build("dla_34", "pallas_full", "bfloat16", opts)
        train = bench_train(cfg, BATCH, 10, device)["images_per_s"]
        res["budget"].update(
            card_train_img_s=train,
            host_feeds_n_cards=best["loader_img_s"] / train,
            cores_per_card_needed=train / per_core)
    print(json.dumps(res["budget"]), flush=True)
    return res


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = run(args.images, args.samples, args.device, args.opts)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.json}")
    return res


if __name__ == "__main__":
    main()
