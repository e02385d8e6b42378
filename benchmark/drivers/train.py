"""Traffic of kind ``train``: the training step at a fixed batch.

Set-up encodes ``pool`` batches of ``batch`` train-augmented hard scenes
(``harness/encode.py``, the compact wire: uint8 images, six colour
coefficients, float16 heatmaps), every row a scene of its own, and pins
them on the host.  It builds one ``Trainer`` (the snapshot's weights,
float32 master parameters, Adam) and drives it through its first
``checked_steps`` steps on the first batches by the window's own call
(``Trainer.train_step`` on a pinned batch, which copies it in), reading
what the check needs on the way: each step's loss, each leaf's first
gradient from Adam's first moment after step 1, and each leaf's change
after the last checked step.  More steps warm up to ``warmup_steps``.
The window then steps through the pool in turn for ``--seconds``,
synchronised at its end: ``train_img_s`` is every image stepped over the
whole window.

Once the window is closed and the program freed, the float32 reference
(``reference/train.py``) runs the same checked steps from the snapshot
on the same batches, and the numbers that the cell's limits name are
compared (``compare``).
"""

from __future__ import annotations

import gc
import re
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import encode, program, scenes
from benchmark.harness.trace import record
from benchmark.reference import train as ref_train

_PATH = re.compile(r"\['([^']+)'\]")
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def pool(seed: int, traffic: dict) -> List[Dict[str, np.ndarray]]:
    """The ``pool`` batches of ``seed``: every row its own scene."""
    f, b = traffic["frame"], traffic["batch"]
    out = []
    for j in range(traffic["pool"]):
        rows = []
        for i in range(b):
            img, anns = scenes.render_scene_hard(
                np.random.default_rng([seed, 4, j, i]), f, f,
                traffic["people"])
            rows.append(encode.encode(img, anns,
                                      np.random.default_rng([seed, 5, j, i]),
                                      in_res=f))
        out.append(encode.stack(rows))
    return out


def param_name(npz_key: str) -> str:
    """The program's parameter name of a ``params`` leaf of the snapshot
    (the flax path joined by dots, the leaf renamed)."""
    parts = _PATH.findall(npz_key.partition(":")[2])
    return ".".join(parts[:-1] + [_LEAF.get(parts[-1], parts[-1])])


def leaf_keys(snapshot: str) -> Dict[str, str]:
    """{program parameter name: snapshot key} of every ``params`` leaf."""
    with np.load(snapshot) as data:
        return {param_name(k): k for k in data.files
                if k.startswith("params:")}


def run(ctx) -> dict:
    cfg, tr, seed = ctx.cfg, ctx.traffic, ctx.seed
    dev = torch.device(ctx.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    program.set_tf32(cfg)
    batches = pool(seed, tr)
    host = batches
    if dev.type == "cuda":
        host = [{k: torch.from_numpy(v).pin_memory() for k, v in b.items()}
                for b in batches]
    snap = program.snapshot(ctx.root, cfg)
    trainer = program.trainer(ctx.root, cfg, ctx.device, **ctx.overrides)
    readings = first_steps(trainer, host, tr, leaf_keys(snap))
    sync()
    setup_s = time.perf_counter() - ctx.t0

    steps = 0
    begin = time.perf_counter()
    deadline = begin + ctx.seconds
    now = begin
    while now < deadline:
        trainer.train_step(host[steps % len(host)])
        steps += 1
        now = time.perf_counter()
    sync()
    window = time.perf_counter() - begin
    out = {"metrics": {"train_img_s": steps * tr["batch"] / window,
                       "setup_s": setup_s},
           "attempted": steps * tr["batch"], "failed": 0}
    if ctx.trace:
        out["trace"] = record(
            lambda j: trainer.train_step(host[(steps + j) % len(host)]),
            tr["trace_steps"], sync, dev.type == "cpu")
        out["info"] = {"kind": "train", "batch": tr["batch"],
                       "images_per_item": tr["batch"]}
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del trainer, host
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_train.steps(cfg, snap, batches[:tr["checked_steps"]], dev)
    gaps = compare(*readings, ref, list(ctx.limits))
    out["checks"] = {f"{k}_gap": (gaps[k], lim)
                     for k, lim in ctx.limits.items()}
    return out


def first_steps(trainer, host, tr: dict, names: Dict[str, str]):
    """Drive ``trainer`` through its ``warmup_steps`` first steps on the
    pool ``host`` in turn, and return (the loss of each of the first
    ``checked_steps``, {leaf: norm of its first gradient, read from Adam's
    first moment after step 1}, {leaf: norm of its change after the last
    checked step}); leaves by snapshot key."""
    params = dict(trainer.model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    b1 = ref_train.ADAM["b1"]
    losses, grad, delta = [], {}, {}
    for step in range(max(tr["warmup_steps"], tr["checked_steps"])):
        stats = trainer.train_step(host[step % len(host)])
        if step < tr["checked_steps"]:
            losses.append(float(stats["loss"]))
        if step == 0:
            opt = trainer.optimizer.opt
            for n, p in params.items():
                st = opt.state.get(p, {})
                if "exp_avg" in st:
                    grad[names[n]] = float(st["exp_avg"].norm()) / (1 - b1)
        if step == tr["checked_steps"] - 1:
            for n, p in params.items():
                delta[names[n]] = float((p.detach() - start[n]).norm())
    return losses, grad, delta


def compare(losses, grad, delta, ref, names) -> Dict[str, float]:
    """The numbers ``names`` (of ``NUMBERS``) of the program's first steps
    (``first_steps``) against the reference's ``ref`` (``steps``).  Leaves
    by snapshot key; a leaf counts among the ``moved`` where its reference
    gradient is at least a thousandth of the median leaf's (Adam moves the
    others by rounding alone)."""
    if len(losses) < len(ref["loss"]):
        return {k: float("inf") for k in names}
    keys = sorted(ref["grad"])
    med = float(np.median([ref["grad"][k] for k in keys]))
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
    # the DCN sites' weights, whose gradient the DCN backward computes
    # (their biases, under BatchNorm, have a gradient of nought to rounding)
    dcn = [k for k in moved if k.endswith("['DCN_0']['kernel']")]
    prog = {"grad": {k: grad.get(k, 0.0) for k in keys},
            "delta": {k: delta.get(k, 0.0) for k in moved}}

    def median_gap(what, ks):
        return float(np.median([abs(prog[what][k] - ref[what][k])
                                / max(ref[what][k], 1e-30) for k in ks]))

    def worst(what, ks):
        floor = float(np.median([ref[what][k] for k in moved]))
        return ref_train.worst_leaf(prog[what], ref[what], ks, floor)

    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])]
    numbers = {"loss": lambda: rel[0], "loss_worst": lambda: max(rel),
               "grad": lambda: median_gap("grad", moved),
               "grad_worst": lambda: worst("grad", moved),
               "grad_dcn": lambda: median_gap("grad", dcn),
               "grad_dcn_worst": lambda: worst("grad", dcn),
               "delta": lambda: median_gap("delta", moved),
               "delta_worst": lambda: worst("delta", moved),
               "delta_dcn_worst": lambda: worst("delta", dcn)}
    return {k: numbers[k]() for k in names}


# the numbers ``compare`` can read: the first step's relative loss gap and
# the worst step's; of the first gradient's norm and of the change's norm
# after the checked steps, the gap relative to the leaf's norm at the
# median moved leaf and at the median DCN site's weight, and the gap at
# the worst moved leaf and at the worst DCN site's weight (against the
# larger of the leaf's norm and the median moved leaf's)
NUMBERS = ("loss", "loss_worst", "grad", "grad_worst", "grad_dcn",
           "grad_dcn_worst", "delta", "delta_worst", "delta_dcn_worst")
