"""Scaling benchmark: images/s per GPU at world sizes 1 -> N, counterpart
of ``tools/bench_scaling.py``.

    python -m centerpose_tpu_torch.tools.bench_scaling [--cfg FILE | \
        --defaults] [--per-gpu-batch 8] [--nprocs 1,2,4] [--iters 20] \
        [--input-res N] [--device cuda|cpu] [KEY VALUE ...]

Weak scaling, as the reference measures it: for each world size n of
``--nprocs`` it starts n processes itself (one rank each, rendezvous on a
free local port; nccl on the card, one card per rank, gloo on the CPU),
each rank builds the data-parallel
``Trainer`` (``parallel/mesh.py``) at the global batch ``n *
per_gpu_batch`` and feeds its shard of one batch encoded from synthetic
scenes at the input size (seed 0, no train augmentation, as the
reference's), steps once to warm up, then
times ``--iters`` steps (host clock around synchronised work).  It prints
one JSON line per world size (step ms, images/s, images/s per GPU, the
device and backend), a world size larger than the CUDA devices is
skipped with a reason, and with more than one measured size a last line
with the efficiency: the worst size's images/s per GPU over the single
process's.  Without ``--cfg`` the config is the flagship's, with
``--defaults`` the config defaults (as ``tools/train.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

RANK_TIMEOUT_S = 900.0  # a rank that has not ended by then is killed
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="data-parallel scaling bench")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--defaults", action="store_true")
    p.add_argument("--per-gpu-batch", type=int, default=8)
    p.add_argument("--nprocs", type=str, default="1")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--input-res", type=int, default=None,
                   help="override the input resolution (output res / 4)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--rank-result", type=str, default=None,
                   help=argparse.SUPPRESS)  # a rank's own run
    p.add_argument("opts", nargs="*", default=[])
    return p.parse_args(argv)


def _config(args):
    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.tools.evaluate import run_config

    cfg = run_config(args.cfg, args.opts, args.defaults)
    if args.input_res:
        cfg = update_config(cfg, {"model": {
            "input_res": args.input_res,
            "output_res": args.input_res // 4}})
    return cfg


def _rank(args) -> None:
    """One rank of one world size (torchrun's environment variables set
    by the launcher); rank 0 writes the timing to ``--rank-result``."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.data.encode import encode_example, stack_batch
    from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
    from centerpose_tpu_torch.parallel import mesh
    from centerpose_tpu_torch.tools.train import _multihost_device
    from centerpose_tpu_torch.train.trainer import Trainer

    if os.environ.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    device = _multihost_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh.init_distributed(device=device)
    try:
        rank, world = mesh.process_index(), mesh.process_count()
        cfg = _config(args)
        b = args.per_gpu_batch
        cfg = update_config(cfg, {"train": {"batch_size": b * world}})
        res = cfg.model.input_res
        ds = SyntheticPoseDataset(b * world, img_w=res, img_h=res)
        exs = []
        for i in range(rank, b * world, world):  # this rank's shard
            img, anns = ds.get_raw(i)
            exs.append(encode_example(img, anns, cfg,
                                      np.random.default_rng(i), False))
        batch = stack_batch(exs)
        trainer = Trainer(cfg, device=device,
                          group=torch.distributed.group.WORLD)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        trainer.train_step(batch)  # warm-up: cuDNN plans, the allocator
        sync()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            stats = trainer.train_step(batch)
        loss = float(stats["loss"])
        sync()
        dt = (time.perf_counter() - t0) / args.iters
        if rank == 0:
            from centerpose_tpu_torch.tools.evaluate import device_name

            with open(args.rank_result, "w") as f:
                json.dump({"step_s": dt, "loss": loss,
                           "device": device_name(str(device)),
                           "backend": torch.distributed.get_backend()}, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, argv: List[str]) -> Dict:
    """Start ``n`` ranks of this tool on ``argv`` and wait for them;
    returns rank 0's timing.  Raises with the ranks' output when one
    fails."""
    with tempfile.TemporaryDirectory(prefix="cp_scaling_") as tmp:
        result = os.path.join(tmp, "rank0.json")
        port = _free_port()
        # the caller's share of the host's cores, split among the ranks
        share = int(os.environ.get("OMP_NUM_THREADS")
                    or len(os.sched_getaffinity(0)))
        threads = max(1, share // n)
        # the ranks import this checkout's package wherever they start
        path = os.pathsep.join(filter(None, (_ROOT, os.environ.get(
            "PYTHONPATH"))))
        procs = []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads),
                       PYTHONPATH=path)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "centerpose_tpu_torch.tools.bench_scaling", *argv,
                 "--rank-result", result],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs, failed = [], False
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                failed = True
            outs.append(out)
            failed |= p.returncode != 0
        if failed:
            raise RuntimeError(f"world size {n}: a rank failed\n"
                               + "\n".join(o[-3000:] for o in outs))
        with open(result) as f:
            return json.load(f)


def main(argv: Optional[List[str]] = None) -> Dict[int, float]:
    """Print one line per world size and the efficiency line; returns
    {world size: images/s per GPU}."""
    args = parse_args(argv)
    if args.rank_result:
        _rank(args)
        return {}
    import torch

    from centerpose_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    gpus = torch.cuda.device_count() if device.type == "cuda" else None
    rank_argv = list(argv if argv is not None else sys.argv[1:])
    results: Dict[int, float] = {}
    for n in (int(v) for v in args.nprocs.split(",")):
        if gpus is not None and n > gpus:
            print(json.dumps({"world_size": n, "skipped":
                              f"{gpus} CUDA device(s), one per rank"}),
                  flush=True)
            continue
        r = run_world(n, rank_argv)
        b = n * args.per_gpu_batch
        ips = b / r["step_s"]
        results[n] = ips / n
        print(json.dumps({
            "world_size": n, "backend": r["backend"], "global_batch": b,
            "step_ms": round(r["step_s"] * 1e3, 2),
            "images_per_s": round(ips, 2),
            "images_per_s_per_gpu": round(ips / n, 2),
            "loss": round(r["loss"], 5), "device": r["device"]}), flush=True)
    if 1 in results and len(results) > 1:
        worst = min(results[n] / results[1] for n in results if n != 1)
        print(json.dumps({
            "metric": "weak-scaling efficiency (worst world size vs 1 GPU)",
            "value": round(worst, 4), "unit": "ratio",
            "vs_baseline": round(worst / 0.90, 2)}), flush=True)
    return results


if __name__ == "__main__":
    main()
