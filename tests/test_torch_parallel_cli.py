"""The port's data-parallel command lines on the CPU: ``tools/train.py
--multihost`` on 2 ranks as torchrun starts them (``env://`` on a freshly
bound port, gloo), and ``tools/bench_scaling.py``, which starts its ranks
itself."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.train.checkpoints import (load_checkpoint,
                                                    restore_state, to_host)
from centerpose_tpu_torch.train.trainer import Trainer

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import bit_equal, share_cores_among_workers

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 300
OPTS = ["model.name", "res_18", "model.input_res", "64",
        "model.output_res", "16", "train.batch_size", "4",
        "train.num_workers", "0", "dataset.max_objs", "4"]


# tools/train.py as ``python -m`` runs it, without TensorBoard's optional
# writer (its import takes seconds here)
_MAIN = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
         "runpy.run_module('centerpose_tpu_torch.tools.train', "
         "run_name='__main__', alter_sys=True)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(world: int, **extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT),
                OMP_NUM_THREADS=str(max(1, share_cores_among_workers()
                                        // world)), **extra)


def _multihost(argv, world: int = 2, attempts: int = 3) -> list:
    """``tools/train.py --multihost --device cpu argv`` on ``world`` ranks
    with torchrun's environment variables; returns each rank's output.
    The port is free when chosen but not held, so another process (another
    xdist worker's ranks) may take it before rank 0 binds it: a run whose
    rendezvous found it taken starts again on a new one."""
    for attempt in range(attempts):
        outs, codes = _multihost_once(argv, world)
        taken = any("EADDRINUSE" in o or "ddress already in use" in o
                    for o in outs)
        if not (taken and any(codes)) or attempt == attempts - 1:
            break
    for r, code in enumerate(codes):
        assert code == 0, f"rank {r} failed:\n" + "\n".join(
            o[-3000:] for o in outs)
    return outs


def _multihost_once(argv, world: int):
    """One run of ``_multihost``: (each rank's output, exit codes)."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MAIN, "--multihost", "--device", "cpu",
         *argv], cwd=ROOT,
        env=_env(world, RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, [p.returncode for p in procs]


def test_multihost_cli_two_ranks(tmp_path):
    """2 ranks, res_18 at 64x64, global batch 4 (2 per rank), 1 epoch of
    2 steps on the 8-image synthetic split, validation loss over the
    sharded val split and AP on 4 images: only rank 0 writes (one run's
    files in the run directory, each line of ``log.txt`` once; rank 1
    prints its lines prefixed); ``model_last`` loads into a one-process
    Trainer bit for bit; a second run with ``train.resume 1`` starts at
    epoch 2 on both ranks from it."""
    out = tmp_path / "out"
    argv = ["--synthetic", "--synthetic-size", "8", "--defaults", *OPTS,
            "output_dir", str(out), "exp_id", "dp"]
    logs = _multihost(argv + ["train.epochs", "1", "train.val_intervals",
                              "1", "train.val_ap_limit", "4"])
    log_dir = out / "dp"
    files = sorted(os.listdir(log_dir))
    opt = [f for f in files if f.startswith("opt_")]
    assert len(opt) == 1 and set(files) - set(opt) == {
        "log.txt", "scalars.jsonl", "model_last", "model_last.meta.json",
        "model_best", "model_best.meta.json"}, files
    log = (log_dir / "log.txt").read_text()
    assert log.count("data-parallel: 2 ranks (gloo), 2 images per rank") == 1
    assert log.count("| done") == 1 and log.count("train epoch 1") == 1
    assert "val_ap epoch 1" in log and "new best" in log
    scalars = [json.loads(line) for line in
               (log_dir / "scalars.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in scalars].count("train/loss") == 1
    assert "[rank 1] train epoch 1" in logs[1] and "[rank 1]" not in logs[0]
    assert "val_ap" not in logs[1]  # the AP pass runs on rank 0

    cfg = update_config(default_config(), {
        "model": {"name": "res_18", "input_res": 64, "output_res": 16},
        "train": {"batch_size": 4}})
    payload = load_checkpoint(str(log_dir / "model_last"))
    assert payload["epoch"] == 1 and payload["step"] == 2
    trainer = restore_state(Trainer(cfg, device="cpu"), payload)
    assert bit_equal(to_host(trainer.state())["model"], payload["model"])

    logs = _multihost(argv + ["train.epochs", "2", "train.resume", "1",
                              "train.val_intervals", "0"])
    for r, text in enumerate(logs):
        prefix = f"[rank {r}] " if r else ""
        assert f"{prefix}resumed from {log_dir / 'model_last'} at epoch 1" \
            in text, text[-2000:]
        assert f"{prefix}train epoch 2" in text
        assert f"{prefix}train epoch 1" not in text
    assert load_checkpoint(str(log_dir / "model_last"))["step"] == 4


def test_bench_scaling_cpu():
    """``tools/bench_scaling --nprocs 1,2`` on the CPU (gloo) at 64x64:
    one line per world size with its global batch and finite rates, then
    the efficiency line."""
    proc = subprocess.run(
        [sys.executable, "-m", "centerpose_tpu_torch.tools.bench_scaling",
         "--defaults", "--device", "cpu", "--nprocs", "1,2",
         "--per-gpu-batch", "2", "--iters", "1", "--input-res", "64",
         "model.name", "res_18", "dataset.max_objs", "4"],
        cwd=ROOT, env=_env(1), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert [r.get("world_size") for r in lines[:2]] == [1, 2]
    for n, row in zip((1, 2), lines):
        assert row["backend"] == "gloo" and row["device"] == "cpu"
        assert row["global_batch"] == 2 * n
        assert row["images_per_s"] > 0 and row["step_ms"] > 0
        assert abs(row["images_per_s_per_gpu"] * n - row["images_per_s"]) \
            < 0.02 * row["images_per_s"]
    assert len(lines) == 3 and lines[2]["unit"] == "ratio"
    assert lines[2]["value"] > 0
