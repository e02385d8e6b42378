"""Where the flagship's step time goes, counterpart of
``tools/ablate_step.py``: deletion and substitution ablations of the
batch-8 512x512 dla_34 serving forward and training step (bf16,
``pallas_full``), on the card unless ``--device cpu`` is given.

    python -m centerpose_tpu_torch.tools.ablate_step [--batch 8] \\
        [--iters 30] [--npz output/dla34_hard_artifact/params_f16.npz] \\
        [--json port_output/step_ablation.json] [--trace-dir DIR] \\
        [--device cpu] [KEY VALUE ...]

Rows, as the reference defines them (``KEY VALUE`` overrides apply to
every model, e.g. ``model.input_res 64 model.output_res 16``):

- ``infer_full``: ``inference/detector.ServingNet`` (``Detector.process``:
  forward, clamped sigmoid, decode at K = ``test.topk``, no flip) on a
  seeded float32 input already on the device;
- ``infer_fwd_only``: the model's forward alone; ``decode`` = full minus
  forward;
- ``trunk``: ``DLASeg.base`` alone, fed as ``DLASeg.forward`` feeds it;
- ``infer_fwd_convsub``: the ``dcn_impl: conv`` model (plain 3x3 convs in
  place of every DCN, seeded init, as ``tools/bench_suite.py`` builds it);
  ``dcn_total_cost`` = forward minus conv forward, ``agg_heads`` = conv
  forward minus trunk;
- ``train_full``, ``train_convsub``: ``Trainer.train_step`` on one seeded
  synthetic batch encoded by the port, and ``train_dcn_total_cost``;
- ``infer_fwd_unfused_om`` (the port's): the forward with
  ``model.dcn_fused_om false`` (om conv, then K2, at every site the
  om-fused kernel K1 would take) and ``om_fold`` = unfused minus fused, the
  in-model A/B of the reference's ``tools/ablate_dcn_overhead.py``.
  Inference only: training never folds.

The DCN models read ``--npz`` (learned offsets: the gather depends on
them, so no offset perturbation is needed).  Each row ``<row>_ms`` is the
wall time per call, warmed up, over ``--iters`` calls (train rows ``max(1,
iters // 2)`` steps), with ``torch.cuda.synchronize()`` as the fence;
``<row>_busy_ms`` the device's busy time per call, the union of its
kernels' and copies' intervals in one ``torch.profiler`` window of
``PROFILE_CALLS`` calls (``None`` on the CPU, where there is no device to
trace); ``<row>_launches`` K1, K2 and backward launches per call over
the timed calls (``ops/dcn_cuda``'s counts, read before and after them;
the counts are never reset here, so a caller that resets them before
``run`` reads every launch of the run after it).  Differences are printed
as measured, also where the host's spread makes them negative.  With
``--trace-dir`` the ``infer_full`` window is saved there as a Chrome
trace.  Every row names the card (``nvidia-smi``'s name and power
limit).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from centerpose_tpu_torch.config import Config
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.tools.bench_suite import build, card, train_batch
from centerpose_tpu_torch.tools.evaluate import SNAPSHOT, no_tf32
from centerpose_tpu_torch.utils.platform import resolve_device
from centerpose_tpu_torch.weights import state_dict_from_npz

DEFAULT_JSON = "port_output/step_ablation.json"
PROFILE_CALLS = 3  # calls in each row's profiler window
# measured rows, and each derived row as (minuend, subtrahend)
MEASURED = ("infer_full", "infer_fwd_only", "trunk", "infer_fwd_convsub",
            "infer_fwd_unfused_om", "train_full", "train_convsub")
DERIVED = {"decode": ("infer_full", "infer_fwd_only"),
           "dcn_total_cost": ("infer_fwd_only", "infer_fwd_convsub"),
           "agg_heads": ("infer_fwd_convsub", "trunk"),
           "om_fold": ("infer_fwd_unfused_om", "infer_fwd_only"),
           "train_dcn_total_cost": ("train_full", "train_convsub")}
KERNELS = {"k1": dc.dcn_v2_fused, "k2": dc.dcn_v2,
           "backward": dc.dcn_v2_backward}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--npz", default=str(SNAPSHOT),
                   help="dla_34 f16 snapshot of the DCN models")
    p.add_argument("--json", default=DEFAULT_JSON)
    p.add_argument("--trace-dir", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    return p.parse_args(argv)


def busy_ms(spans: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of ``spans`` ((start, end) in us), in
    ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_spans(prof) -> List[Tuple[float, float]]:
    """(start, end) in us of every device-side event of a profile, kernels
    and copies; user annotations (``Optimizer.`` marks among them) span
    other events and gaps, so they are left out."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn: Callable[[], object], iters: int, device: torch.device,
            trace_path: Optional[str] = None) -> dict:
    """``fn``'s wall ms per call (one warm-up call, then ``iters``),
    launches per call of K1, K2 and the backward over those calls, and the
    device's busy ms per call over ``PROFILE_CALLS`` traced calls (None on
    the CPU)."""
    fn()
    _sync(device)
    before = {k: f.launches for k, f in KERNELS.items()}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    wall = (time.perf_counter() - t0) / iters * 1e3
    launches = {k: (f.launches - before[k]) / iters
                for k, f in KERNELS.items()}
    busy = None
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_CALLS):
                fn()
            _sync(device)
        spans = device_spans(prof)
        if not spans:
            raise RuntimeError("the profiler recorded no device activity")
        busy = busy_ms(spans) / PROFILE_CALLS
        if trace_path:
            prof.export_chrome_trace(trace_path)
    return {"ms": wall, "busy_ms": busy, "launches": launches}


def model_cfg(impl: str, opts: Sequence[str] = (),
              fused_om: bool = True) -> Config:
    """The reference's ablation config: dla_34, head 256, bf16, ``impl``,
    then ``opts``."""
    return build("dla_34", impl, "bfloat16", [
        "model.dcn_fused_om", str(fused_om).lower(), *opts])


def run(batch: int = 8, iters: int = 30, npz: str = str(SNAPSHOT),
        device: str = "cuda", opts: Sequence[str] = (),
        trace_dir: str = "") -> Dict[str, object]:
    """Every row (see the module docstring), printed as it is done."""
    dev = resolve_device(device)
    weights = state_dict_from_npz(npz)
    cfg = model_cfg("pallas_full", opts)
    res = cfg.model.input_res
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, res, res, 3)).astype(np.float32)).to(dev)
    rows: Dict[str, object] = {"batch": batch, "offsets": f"learned ({npz})",
                               "card": card(device)}
    got: Dict[str, dict] = {}

    def row(name: str, fn, n: int = iters, trace: Optional[str] = None):
        got[name] = measure(fn, n, dev, trace)
        rows[f"{name}_ms"] = got[name]["ms"]
        rows[f"{name}_busy_ms"] = got[name]["busy_ms"]
        rows[f"{name}_launches"] = got[name]["launches"]
        print(json.dumps({"row": name, **got[name]}), flush=True)

    trace = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        trace = os.path.join(trace_dir, "infer_full.json")
        rows["trace"] = trace
    det = Detector(cfg, weights, device=dev)
    model = det.model
    with torch.inference_mode():
        row("infer_full", lambda: det.process(x), trace=trace)
        row("infer_fwd_only", lambda: model(x))
        row("trunk", lambda: model.base(
            x.to(model.compute_dtype).permute(0, 3, 1, 2)))
        del det, model
        conv = Detector(model_cfg("conv", opts), None, device=dev).model
        row("infer_fwd_convsub", lambda: conv(x))
        del conv
        unfused = Detector(model_cfg("pallas_full", opts, fused_om=False),
                           weights, device=dev).model
        row("infer_fwd_unfused_om", lambda: unfused(x))
        del unfused
    from centerpose_tpu_torch.train.trainer import Trainer

    steps = max(1, iters // 2)
    for name, impl, sd in (("train_full", "pallas_full", weights),
                           ("train_convsub", "conv", None)):
        tcfg = model_cfg(impl, opts)
        trainer = Trainer(tcfg, sd, device=dev)
        data = train_batch(tcfg, batch)
        row(name, lambda: trainer.train_step(data), steps)
        del trainer
    for name, (a, b) in DERIVED.items():
        rows[f"{name}_ms"] = got[a]["ms"] - got[b]["ms"]
        rows[f"{name}_busy_ms"] = (None if got[a]["busy_ms"] is None else
                                   got[a]["busy_ms"] - got[b]["busy_ms"])
    return rows


def main(argv=None) -> Dict[str, object]:
    args = parse_args(argv)
    no_tf32()
    rows = run(args.batch, args.iters, args.npz, args.device, args.opts,
               args.trace_dir)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows, indent=1))
    print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
