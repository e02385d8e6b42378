"""Per-backbone benchmark suite on the card, counterpart of
``tools/bench_suite.py``: forward+decode latency and throughput (batch 1
and 8) and train-step throughput, per (``dcn_impl``, ``compute_dtype``)
variant for dla_34.

Rows are merged into ``--json`` (default ``port_output/bench_table.json``;
never the JAX package's ``output/``), and the whole table is written as
markdown beside it (``bench_table.md``):

    python -m centerpose_tpu_torch.tools.bench_suite --archs res_18,res_50
    python -m centerpose_tpu_torch.tools.bench_suite --archs dla_34 \\
        --modes infer,train --variants pallas_full/bfloat16,conv/bfloat16

``infer`` is the serving function (``inference/detector.ServingNet``:
forward, clamped sigmoid, decode at K=100) on a seeded, normalised float32
input already on the device; ``train`` is ``Trainer.train_step`` on one
batch of seeded synthetic images encoded by the port's encoder.  Each is
warmed up, then timed over ``--iters`` calls (train: ``max(5, iters //
2)`` steps) with ``torch.cuda.synchronize()`` as the trailing fence.
dla_34 reads the committed snapshot (learned offsets: K1's and K2's
gather depends on them); ``conv`` (the reference's ablation, no DCN) and
the other archs use the seeded init, as the reference's do.  The default
variant is ``pallas_full/bfloat16`` for dla_34 (the flagship's) and
``bfloat16`` elsewhere; ``conv/bfloat16`` on dla_34 gives the DCN sites'
share of the time.  Every row carries ``card``: the name and power limit
``nvidia-smi`` reports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from centerpose_tpu_torch.config import Config, load_config
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools.evaluate import SNAPSHOT, no_tf32
from centerpose_tpu_torch.utils.platform import resolve_device
from centerpose_tpu_torch.weights import state_dict_from_npz

HEAD_CONV = {"dla_34": 256, "hrnet_w32": 256, "hrnet_w48": 256}  # others 64
DEFAULT_JSON = "port_output/bench_table.json"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--archs", default="dla_34")
    p.add_argument("--modes", default="infer", help="infer,train")
    p.add_argument("--variants", default="default",
                   help="comma list of dcn_impl/dtype, e.g. xla/float32,"
                        "pallas_full/bfloat16; 'default' = "
                        "pallas_full/bfloat16 for dla_34, plain bfloat16 "
                        "otherwise")
    p.add_argument("--batches", default="1,8")
    p.add_argument("--train-batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--json", default=DEFAULT_JSON)
    return p.parse_args(argv)


def card(device: str = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (its
    device name where ``nvidia-smi`` fails); ``cpu`` on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def build(arch: str, dcn_impl: str, dtype: str,
          opts: Sequence[str] = ()) -> Config:
    """The reference's bench config: the defaults with the arch, its head
    width and dtype (and ``dcn_impl`` for dla_34), then ``opts``."""
    cfg_opts = ["model.name", arch,
                "model.head_conv", str(HEAD_CONV.get(arch, 64)),
                "model.compute_dtype", dtype]
    if arch == "dla_34":
        cfg_opts += ["model.dcn_impl", dcn_impl]
    return load_config(opts=cfg_opts + list(opts))


def bench_weights(cfg: Config):
    """dla_34 with DCN: the snapshot (learned offsets); otherwise None (the
    seeded init)."""
    if cfg.model.name != "dla_34" or cfg.model.dcn_impl == "conv":
        return None
    return state_dict_from_npz(str(SNAPSHOT))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_infer(cfg: Config, batch: int, iters: int,
                device: str = "cuda") -> Dict[str, float]:
    det = Detector(cfg, bench_weights(cfg), device=device)
    res = cfg.model.input_res
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, res, res, 3)).astype(np.float32)).to(det.device)
    det.process(x)  # warm-up: cuDNN plans, allocator
    _sync(det.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        dets = det.process(x)
    _sync(det.device)
    dt = time.perf_counter() - t0
    assert tuple(dets.shape) == (batch, cfg.test.topk, 40)
    return {"ms_per_batch": round(dt / iters * 1e3, 2),
            "images_per_s": round(batch * iters / dt, 2)}


def train_batch(cfg: Config, batch: int) -> Dict[str, np.ndarray]:
    """One batch of seeded synthetic scenes, encoded with train
    augmentation."""
    from centerpose_tpu_torch.data.encode import encode_example, stack_batch
    from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset

    ds = SyntheticPoseDataset(batch, seed=0)
    rng = np.random.default_rng(0)
    return stack_batch([encode_example(img, anns, cfg, rng, True)
                        for img, anns in (ds.get_raw(i)
                                          for i in range(batch))])


def bench_train(cfg: Config, batch: int, iters: int,
                device: str = "cuda") -> Dict[str, float]:
    from centerpose_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, bench_weights(cfg), device=device)
    data = train_batch(cfg, batch)
    float(trainer.train_step(data)["loss"])  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        stats = trainer.train_step(data)
    _sync(trainer.device)
    dt = time.perf_counter() - t0
    assert np.isfinite(float(stats["loss"]))
    return {"ms_per_step": round(dt / iters * 1e3, 2),
            "images_per_s": round(batch * iters / dt, 2)}


def merge_rows(table: List[dict], rows: List[dict]) -> List[dict]:
    """Upsert ``rows`` into ``table`` by (arch, variant, mode, batch) and
    sort by (arch, mode, variant, batch), as the reference does."""
    def key(r):
        return (r["arch"], r["variant"], r["mode"], r["batch"])

    table = list(table)
    for row in rows:
        table = [r for r in table if key(r) != key(row)] + [row]
    table.sort(key=lambda r: (r["arch"], r["mode"], r["variant"], r["batch"]))
    return table


def write_table(table: List[dict], path: str) -> None:
    """The table as JSON at ``path`` and as markdown beside it
    (``.md``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    cards = sorted({r.get("card", "unknown") for r in table})
    lines = [
        f"# Per-backbone performance ({'; '.join(cards)})",
        "",
        "Steady state, warm-up excluded, `torch.cuda.synchronize()` as the",
        "trailing fence.  `infer` = forward + clamped sigmoid + decode",
        "(K=100) from a normalised float32 input on the device; `train` =",
        "`Trainer.train_step` on one encoded batch.  dla_34 rows with DCN",
        "run the snapshot's learned offsets.  `video` and `eval_msflip`",
        "include the host pre-process and the uploads (`h2d_GBps`: pinned",
        "host-to-device rate measured beside them).",
        "",
        "| arch | variant | mode | batch | ms | images/s | card |",
        "|---|---|---|---|---|---|---|",
    ]
    for row in table:
        ms = row.get("ms_per_batch", row.get("ms_per_step"))
        lines.append(f"| {row['arch']} | {row['variant']} | {row['mode']} | "
                     f"{row['batch']} | {ms} | {row['images_per_s']} | "
                     f"{row.get('card', '')} |")
    with open(os.path.splitext(path)[0] + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")


def read_table(path: str) -> List[dict]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def run(archs: Sequence[str], modes: Sequence[str], variants: str = "default",
        batches: Sequence[int] = (1, 8), train_batch_size: int = 8,
        iters: int = 20, device: str = "cuda",
        opts: Sequence[str] = ()) -> List[dict]:
    """The rows of every (arch, variant, mode, batch), each printed as a
    JSON line when done.  ``opts``: config overrides for every run."""
    name = card(device)
    rows = []
    for arch in archs:
        if variants == "default":
            pairs = [("pallas_full" if arch == "dla_34" else "xla",
                      "bfloat16")]
        else:
            pairs = [tuple(v.split("/")) for v in variants.split(",")]
        for dcn_impl, dtype in pairs:
            vname = f"{dcn_impl}/{dtype}" if arch == "dla_34" else dtype
            cfg = build(arch, dcn_impl, dtype, opts)
            cases = [("infer", b) for b in batches] if "infer" in modes else []
            if "train" in modes:
                cases.append(("train", train_batch_size))
            for mode, batch in cases:
                if mode == "infer":
                    r = bench_infer(cfg, batch, iters, device)
                else:
                    r = bench_train(cfg, batch, max(5, iters // 2), device)
                row = dict(arch=arch, variant=vname, mode=mode, batch=batch,
                           **r, card=name)
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    no_tf32()
    rows = run(args.archs.split(","), args.modes.split(","), args.variants,
               [int(b) for b in args.batches.split(",")], args.train_batch,
               args.iters)
    table = merge_rows(read_table(args.json), rows)
    write_table(table, args.json)
    print(f"wrote {args.json} + {os.path.splitext(args.json)[0]}.md")
    return table


if __name__ == "__main__":
    main()
