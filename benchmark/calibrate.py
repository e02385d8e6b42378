"""Readings that the correctness limits of a cell are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--f64] [--dump] [--compute-dtype float32] \\
        [--out <file.json>]

In one process, at the cell's own sizes.  A serving cell: for each seed,
the program's rows of every distinct batch the cell's traffic sends
(``run_batch`` after the cell's warm-up) judged against the float32
reference (``reference/judge.gaps``, the cell's limits as the ties): the
readings of sound runs.  For each control seed, the control's rows judged
the same way (the reference put in the program's place and computed one
precision step below the configuration's, ``control_numerics``, its maps
decoded by the reference's own decode), and the program's rows with each
decode fault of ``tests/faults.py`` planted.  The training cell:
``calibrate_train``.  Prints one JSON object (and writes it to ``--out``):
the readings per seed of each side, the largest program reading
(``lower``) and the smallest reading of each other side
(``upper_<side>``) of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.drivers import stream  # noqa: E402
from benchmark.harness import program  # noqa: E402
from benchmark.harness.manifest import Manifest  # noqa: E402
from benchmark.reference import judge, nets  # noqa: E402
from benchmark.tests import faults  # noqa: E402


def control_numerics(cfg: dict) -> tuple:
    """(numerics, tf32) of the control: float8 operands for a bfloat16
    configuration, TF32 for a float32 one with TF32 off."""
    if cfg["precision"] == "bfloat16":
        return "fp8", False
    return "f32", True


def control_gaps(p: nets.Params, cfg, work, maps, k: int, tie) -> dict:
    """The control's gaps over the batches ``work`` against the reference's
    ``maps`` of them."""
    mode, tf32 = control_numerics(cfg)
    served = {}
    with torch.no_grad(), nets.tf32(tf32):
        for i, fr in enumerate(work):
            x = torch.from_numpy(fr).to(maps[i]["hm"].device)
            rows = judge.decode(judge.serve_maps(cfg, nets.Numerics(mode), p,
                                                 x), k)
            served[i] = rows.cpu().numpy()
    return stream.judge_rows(served, maps, tie)


def _summary(out: dict, sides) -> None:
    """``lower`` (the program's largest reading) and ``upper_<side>`` (the
    side's smallest) of each number, into ``out``."""
    names = sorted(next(iter(out["program"].values())))
    out["lower"] = {n: max(g[n] for g in out["program"].values())
                    for n in names}
    for side in sides:
        if out.get(side):
            out[f"upper_{side}"] = {n: min(g[n] for g in out[side].values())
                                    for n in names}


def _worst(served, maps, tie, dev) -> dict:
    """Where the widest ``missed`` and ``joint`` gaps of the served calls
    lie ({number: the batch and the judge's detail there})."""
    g = {i: judge.gaps(torch.from_numpy(rows).to(dev), maps[i], tie)
         for i, rows in served.items()}
    out = {}
    for name in ("missed", "joint"):
        i = max(g, key=lambda i: g[i][name])
        detail = {"batch": i}
        judge.gaps(torch.from_numpy(served[i]).to(dev), maps[i], tie, detail)
        out[name] = detail if name == "missed" else dict(
            batch=i, **detail["joint"])
    return out


def calibrate(ctx, seeds, control_seeds) -> dict:
    cfg, tr, tie = ctx.cfg, ctx.traffic, ctx.limits
    dev = torch.device(ctx.device)
    program.set_tf32(cfg)
    det = program.detector(ctx.root, cfg, ctx.device, **ctx.overrides)
    p = nets.Params(program.snapshot(ctx.root, cfg), dev)
    sides = ["control", *faults.DECODE]
    out = {"workload": ctx.cell["name"], "program": {},
           **{side: {} for side in sides}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        work = stream.batches(seed, tr, stream.frames(seed, tr))
        maps = stream.reference_maps(ctx.root, cfg, dev,
                                     dict(enumerate(work)))
        runs = {"program": None} if seed in seeds else {}
        if seed in control_seeds:
            runs.update({name: name for name in faults.DECODE})
        for side, fault in runs.items():
            with (faults.decode_fault(fault) if fault
                  else contextlib.nullcontext()):
                for i in range(tr["warmup_batches"]):
                    det.run_batch(work[i % len(work)])
                served = {i: det.run_batch(b) for i, b in enumerate(work)}
            out[side][seed] = stream.judge_rows(served, maps, tie)
            if side == "program":
                out.setdefault("worst_at", {})[seed] = _worst(served, maps,
                                                             tie, dev)
        if seed in control_seeds:
            out["control"][seed] = control_gaps(p, cfg, work, maps, det.k,
                                                tie)
        del maps
    _summary(out, sides)
    return out


# the training cell's control: float8 operands and float8 activations, as
# the step stores its activations in its compute precision (bfloat16);
# float8 operands alone move the first loss less than bfloat16 does on
# some seeds
TRAIN_CONTROL = "fp8a"


def half_batch(trainer):
    """The fault of a step that leaves half the batch out: each step
    trains on the first half of its rows alone."""
    step = trainer.train_step

    def broken(batch):
        return step({k: v[: len(v) // 2] for k, v in batch.items()})
    trainer.train_step = broken
    return trainer


def calibrate_train(ctx, seeds, control_seeds, f64: bool = False,
                    dump: bool = False) -> dict:
    """The training cell's readings (``drivers/train.compare``, every
    number of ``NUMBERS``): per seed, the program's first steps against
    the float32 reference; per control seed, the reference in float8
    (``TRAIN_CONTROL``) put in the program's place, the program with half
    of each batch left out, the program with the DCN weight gradient
    summed over half the batch (``faults.dcn_weight_grad_half``), and the
    float32 reference on the batch's rows in reverse order (another summation
    order: how far rounding alone moves each number).  ``f64``: on the
    first control seed also the float32 reference and the program against
    the reference in float64.  ``dump``: every leaf's norms of each side
    and of the reference too (``norms``)."""
    from benchmark.drivers import train
    from benchmark.reference import train as ref_train

    cfg, tr = ctx.cfg, ctx.traffic
    dev = torch.device(ctx.device)
    program.set_tf32(cfg)
    snap = program.snapshot(ctx.root, cfg)
    names = train.leaf_keys(snap)
    checked = dict(tr, warmup_steps=tr["checked_steps"])
    sides = ["control", "half_batch", "dcn_weight_grad_half", "reversed"]
    out = {"workload": ctx.cell["name"], "program": {},
           **{side: {} for side in sides}}

    def compare(r, ref):
        return train.compare(*r, ref, train.NUMBERS)

    for seed in sorted(set(seeds) | set(control_seeds)):
        batches = train.pool(seed, tr)[: tr["checked_steps"]]
        host = [{k: torch.from_numpy(v) for k, v in b.items()}
                for b in batches]
        if dev.type == "cuda":
            host = [{k: v.pin_memory() for k, v in b.items()} for b in host]
        runs = {}
        if seed in seeds:
            runs["program"] = (contextlib.nullcontext, lambda t: t)
        if seed in control_seeds:
            runs["half_batch"] = (contextlib.nullcontext, half_batch)
            runs["dcn_weight_grad_half"] = (faults.dcn_weight_grad_half,
                                            lambda t: t)
        readings = {}
        for side, (fault, wrap) in runs.items():
            with fault():
                t = wrap(program.trainer(ctx.root, cfg, ctx.device,
                                         **ctx.overrides))
                readings[side] = train.first_steps(t, host, checked, names)
            del t
            torch.cuda.empty_cache()
        ref = ref_train.steps(cfg, snap, batches, dev)
        for side, r in readings.items():
            out[side][seed] = compare(r, ref)
        if dump:
            out.setdefault("norms", {})[seed] = {
                "reference": ref, **{side: dict(zip(("loss", "grad",
                                                     "delta"), r))
                                     for side, r in readings.items()}}
        if seed in control_seeds:
            c = ref_train.steps(cfg, snap, batches, dev, TRAIN_CONTROL)
            out["control"][seed] = compare((c["loss"], c["grad"],
                                            c["delta"]), ref)
            if dump:
                out["norms"][seed]["control"] = c
            rev = [{k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
                   for b in batches]
            c = ref_train.steps(cfg, snap, rev, dev)
            out["reversed"][seed] = compare((c["loss"], c["grad"],
                                             c["delta"]), ref)
            if f64 and seed == min(control_seeds):
                out["f64"] = _f64_look(cfg, snap, batches, dev, ref,
                                       readings, compare)
        torch.cuda.empty_cache()
    _summary(out, sides)
    return out


def _f64_look(cfg, snap, batches, dev, ref, readings, compare) -> dict:
    """The float32 reference and the program against the reference in
    float64 on the same batches."""
    from benchmark.reference import train as ref_train

    try:
        r64 = ref_train.steps(cfg, snap, batches, dev, dtype=torch.float64)
    except torch.cuda.OutOfMemoryError as e:
        return {"error": str(e).splitlines()[0]}
    look = {"reference_f32": compare((ref["loss"], ref["grad"],
                                      ref["delta"]), r64)}
    if "program" in readings:
        look["program"] = compare(readings["program"], r64)
    return look


def main(argv=None) -> int:
    from benchmark.run import Context

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--f64", action="store_true",
                   help="training: read the float32 reference against "
                        "float64 too")
    p.add_argument("--dump", action="store_true",
                   help="training: every leaf's norms of each side too")
    p.add_argument("--compute-dtype", default="",
                   help="run the program in this compute dtype instead of "
                        "the configuration's (a witness of its rounding)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    m = Manifest()
    cell = m.cell(args.workload)
    ctx = Context(ROOT, cell, m.config(cell), m.traffic(cell), m.limits(cell),
                  0, 0.0, False, device="cuda")
    if args.compute_dtype:
        ctx.overrides = {"model": {"compute_dtype": args.compute_dtype}}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    t = time.perf_counter()
    if ctx.traffic["kind"] == "train":
        res = calibrate_train(ctx, seeds, cseeds, args.f64, args.dump)
    else:
        res = calibrate(ctx, seeds, cseeds)
    res["seconds"] = time.perf_counter() - t
    res["card"] = torch.cuda.get_device_name(0)
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
