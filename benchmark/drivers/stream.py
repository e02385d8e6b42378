"""Traffic of kind ``stream``: a video or camera stream served in batches.

One client in a closed loop hands ``batch`` uint8 frames of ``frame`` x
``frame`` pixels to the serving entry (``Detector.run_batch``: upload,
normalisation, forward, decode, read-back of the decoded rows) and waits
for the rows before sending the next batch.  The frames are hard
synthetic scenes (``harness/scenes.py``, ``people`` persons each) rendered
from the seed at set-up, ``pool`` of them; ``distinct`` batches are drawn
from the pool (each ``batch`` distinct frames) and sent in turn.  Every
seed gives the same sizes, batches and order of work; only the pictures
differ.

The window's numbers: ``serve_img_s``, every frame returned over the
whole window; ``serve_batch_ms_p95``, the 95th percentile of every
batch's wall time in it.  A traced run then serves ``trace_batches`` more
under the profiler.  The check judges every row of ``check_batches``
calls drawn from the seed (the window's last among them) against the
float32 reference (``reference/judge.py``), once the program is freed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import program, scenes
from benchmark.harness.trace import record
from benchmark.reference import judge, nets


def frames(seed: int, traffic: dict) -> np.ndarray:
    """The pool of frames [pool, F, F, 3] uint8 of ``seed``."""
    f = traffic["frame"]
    return np.stack([scenes.render_scene_hard(
        np.random.default_rng([seed, 1, i]), f, f, traffic["people"])[0]
        for i in range(traffic["pool"])])


def batches(seed: int, traffic: dict, pool: np.ndarray) -> List[np.ndarray]:
    """The ``distinct`` batches of ``seed``, each ``batch`` distinct frames
    of the pool, contiguous on the host."""
    rng = np.random.default_rng([seed, 2])
    return [np.ascontiguousarray(pool[rng.choice(len(pool), traffic["batch"],
                                                 replace=False)])
            for _ in range(traffic["distinct"])]


def reference_maps(root, cfg: dict, device,
                   frames_by_batch: Dict[int, np.ndarray]):
    """{batch index: the float32 reference's merged head maps} of the given
    frames, one batch at a time (``judge.serve_maps``), TF32 off."""
    p = nets.Params(program.snapshot(root, cfg), device)
    nx = nets.Numerics("f32")
    out = {}
    with torch.no_grad(), nets.tf32(False):
        for i, fr in frames_by_batch.items():
            out[i] = judge.serve_maps(cfg, nx, p, torch.from_numpy(fr).to(
                device))
    return out


def judge_rows(served: Dict[int, np.ndarray], maps: Dict[int, dict],
               tie: Dict[str, float]) -> Dict[str, float]:
    """The largest of each gap over the served calls {call: rows}, each
    judged against the maps of its batch {call: maps}, with the cell's
    limits ``tie`` (``judge.gaps``)."""
    worst: Dict[str, float] = {}
    for i, rows in served.items():
        m = maps[i]
        g = judge.gaps(torch.from_numpy(rows).to(m["hm"].device), m, tie)
        for k, v in g.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def run(ctx) -> dict:
    cfg, tr, seed = ctx.cfg, ctx.traffic, ctx.seed
    dev = torch.device(ctx.device)
    program.set_tf32(cfg)
    pool = frames(seed, tr)
    work = batches(seed, tr, pool)
    det = program.detector(ctx.root, cfg, ctx.device, **ctx.overrides)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for i in range(tr["warmup_batches"]):
        det.run_batch(work[i % len(work)])
    sync()
    setup_s = time.perf_counter() - ctx.t0

    served: List[np.ndarray] = []
    times: List[float] = []
    start = time.perf_counter()
    deadline = start + ctx.seconds
    t1 = start
    while t1 < deadline:
        t0 = time.perf_counter()
        served.append(det.run_batch(work[len(served) % len(work)]))
        t1 = time.perf_counter()
        times.append(t1 - t0)
    window = t1 - start
    n = len(served)
    out = {"metrics": {
        "serve_img_s": n * tr["batch"] / window,
        "serve_batch_ms_p95": float(np.percentile(np.array(times) * 1e3, 95)),
        "setup_s": setup_s},
        "attempted": n * tr["batch"], "failed": 0}

    if ctx.trace:
        out["trace"] = record(
            lambda j: det.run_batch(work[(n + j) % len(work)]),
            tr["trace_batches"], sync, dev.type == "cpu")
        out["info"] = {"kind": "serve", "batch": tr["batch"],
                       "images_per_item": tr["batch"]}
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del det
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: every row of a sample of the window's calls, the last
    # among them
    rng = np.random.default_rng([seed, 3])
    k = min(tr["check_batches"], n)
    calls = sorted(set(rng.choice(n - 1, k - 1, replace=False).tolist()
                       if n > 1 else []) | {n - 1})
    inputs = {c % len(work) for c in calls}
    maps = reference_maps(ctx.root, cfg, dev, {i: work[i] for i in inputs})
    gaps = judge_rows({c: served[c] for c in calls},
                      {c: maps[c % len(work)] for c in calls}, ctx.limits)
    out["checks"] = {f"{name}_gap": (gaps[name], ctx.limits[name])
                     for name in ctx.limits}
    return out
