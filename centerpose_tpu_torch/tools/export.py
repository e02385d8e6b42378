"""Deployment export CLI, counterpart of ``tools/export.py``.

The reference ships ONNX and TensorRT converters; the JAX package writes a
StableHLO artifact and compiles an AOT engine.  Here:

* ``--format export`` (the StableHLO analog): ``torch.export`` of the
  serving function (``inference/detector.ServingNet``: normalised float32
  images -> forward, clamped sigmoid, flip average, decode; the weights,
  mean and std held in the program) at one static input shape, saved as a
  ``.pt2`` with ``torch.export.save``, reloaded and run.  Each DCN call
  stays one node: K1 (the operator ``centerpose::dcn_v2_fused``) at an
  om-fused site, K2 (``centerpose::dcn_v2``) at every other.
* ``--format aot`` (the engine analog): the same program compiled by
  ``torch.compile(fullgraph=True)`` for the current device; compile time,
  FLOPs per call (``FlopCounterMode``, K1 and K2 by their formulas) and
  memory.  Not persisted, as the reference's is not.
* ``--load PATH`` runs an artifact on zeros of its input shape.

    python -m centerpose_tpu_torch.tools.export --format export \\
        --out port_output/res_18.pt2 [--batch 8] [--device cpu] [KEY VALUE ...]
    python -m centerpose_tpu_torch.tools.export --format aot [--batch 8] ...
    python -m centerpose_tpu_torch.tools.export --load port_output/res_18.pt2

As the reference: without ``--cfg`` the config defaults with the
``KEY VALUE`` overrides; weights from ``test.model_path``
(``tools/evaluate.load_detector``), else the model's seeded random init;
the input is [batch, res, res, 3] float32, doubled in batch under
``test.flip_test`` (the reference's ``_example_input``; the serving
function flips again, so the program returns 2 x batch rows there).  The
default output is ``port_output/<exp_id>/<model>_b<batch>.pt2``.

A bf16 program is run by ``load_serving`` as eager serving runs it: its
convolutions may use TF32 on the card (``models/common.tf32_convs``),
which a traced graph does not record, so the artifact records its
compute dtype (``extra_files``) and the loader sets that scope.
"""

from __future__ import annotations

import argparse
import copy
import os
import time
import warnings

import torch

from centerpose_tpu_torch.config import Config
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.common import tf32_convs
from centerpose_tpu_torch.tools.evaluate import (load_detector, no_tf32,
                                                 run_config, run_dir)
from centerpose_tpu_torch.utils.platform import resolve_device

# the extra file of a .pt2 that names the program's compute dtype
DTYPE_FILE = "compute_dtype"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch export")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--format", choices=("export", "aot"), default="export")
    p.add_argument("--out", type=str, default=None,
                   help="output artifact path")
    p.add_argument("--batch", type=int, default=1, help="serving batch size")
    p.add_argument("--load", type=str, default=None,
                   help="load and run an existing .pt2 artifact and exit")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", nargs="*")
    return p.parse_args(argv)


def build_detector(cfg: Config, device: str) -> Detector:
    """The reference's weights rule: ``test.model_path`` when set, else
    the model's seeded random init."""
    if cfg.test.model_path:
        return load_detector(cfg, device)
    return Detector(cfg, None, device=device)


def example_input(cfg: Config, batch: int, device) -> torch.Tensor:
    """Zeros [n, res, res, 3] float32, n = batch, doubled under
    ``test.flip_test`` (the reference's ``_example_input``)."""
    n = batch * (2 if cfg.test.flip_test else 1)
    res = cfg.model.input_res
    return torch.zeros((n, res, res, 3), dtype=torch.float32,
                       device=resolve_device(device))


def export_serving(det: Detector, x: torch.Tensor):
    """``torch.export`` of ``det.net`` at ``x``'s shape (no gradients)."""
    import torch.export

    with torch.no_grad():
        return torch.export.export(det.net, (x,), strict=False)


def save_serving(program, det: Detector, path: str) -> None:
    import torch.export

    with warnings.catch_warnings():
        # channels_last weights are not contiguous, which the packer
        # reports; it stores each storage whole, with the strides
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, path, extra_files={
            DTYPE_FILE: det.cfg.model.compute_dtype})


def input_spec(program) -> torch.Tensor:
    """The fake tensor of the program's one user input (shape, dtype,
    device)."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == name)
    return node.meta["val"]


class ServingProgram:
    """An exported serving function, called as eager serving calls it:
    without gradients and, for a bf16 program on the card, with cuDNN's
    TF32 on (``tf32_convs``; in a bf16 model every f32 convolution reads
    bf16 values, as in eager serving)."""

    def __init__(self, program, compute_dtype: str):
        self.program = program
        self.module = program.module()
        self.dtype = getattr(torch, compute_dtype)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), tf32_convs(images, self.dtype):
            return self.module(images)

    def compiled(self) -> "ServingProgram":
        """The same program through ``torch.compile(fullgraph=True)`` (it
        compiles at its first call, inside this scope).  Inductor keeps
        every rounding to a narrow dtype that the graph makes
        (``emulate_precision_casts``): by default a fused kernel computes
        its bf16 ops in f32 and rounds once at the end, where the port
        rounds as the reference's compiled graph does."""
        out = copy.copy(self)
        out.module = torch.compile(self.module, fullgraph=True, options={
            "emulate_precision_casts": True})
        return out

    def flops(self, images: torch.Tensor) -> int:
        """FLOPs of one call (``FlopCounterMode``; K1 and K2 by their
        formulas)."""
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            self(images)
        return counter.get_total_flops()

    def weight_bytes(self) -> int:
        tensors = [*self.program.state_dict.values(),
                   *self.program.constants.values()]
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor))


def load_serving(path: str) -> ServingProgram:
    """A ``.pt2`` written by ``save_serving``, run in its dtype's scope:
    the loader of ``--load``, of the export's round trip and of the card's
    smoke run."""
    import torch.export

    extra = {DTYPE_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return ServingProgram(program, extra[DTYPE_FILE] or "float32")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def export_artifact(cfg: Config, batch: int, out_path: str,
                    device: str) -> ServingProgram:
    det = build_detector(cfg, device)
    x = example_input(cfg, batch, device)
    t0 = time.perf_counter()
    program = export_serving(det, x)
    save_serving(program, det, out_path)
    t1 = time.perf_counter()
    outs = [tuple(n.meta["val"].shape) for n in program.graph.output_node()
            .args[0]]
    print(f"[export] torch.export artifact: {out_path}")
    print(f"[export]   input  {tuple(x.shape)} {x.dtype}")
    print(f"[export]   outputs {outs}")
    print(f"[export]   size {os.path.getsize(out_path) / 1e6:.2f} MB, "
          f"export {t1 - t0:.2f}s")
    served = load_serving(out_path)
    dets = served(x)
    with torch.inference_mode():
        equal = torch.equal(dets, det.process(x))
    print(f"[export]   round-trip OK: dets {tuple(dets.shape)}, equal to "
          f"eager: {equal}")
    return served


def export_aot(cfg: Config, batch: int, device: str) -> dict:
    det = build_detector(cfg, device)
    dev = det.device
    x = example_input(cfg, batch, dev)
    t0 = time.perf_counter()
    served = ServingProgram(export_serving(det, x), cfg.model.compute_dtype)
    t1 = time.perf_counter()
    engine = served.compiled()
    engine(x)
    _sync(dev)
    t2 = time.perf_counter()
    flops = served.flops(x)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    dets = engine(x)
    _sync(dev)
    out_mb = dets.numel() * dets.element_size() / 1e6
    temp = "not measured (CPU)"
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) - base
        temp = f"{peak / 1e6 - out_mb:.1f} MB"
    print(f"[export] AOT compile (torch.compile, fullgraph) for {dev}")
    print(f"[export]   export {t1 - t0:.2f}s, compile {t2 - t1:.2f}s")
    print(f"[export]   flops per call: {flops:.3e}")
    print(f"[export]   memory: weights {served.weight_bytes() / 1e6:.1f} MB, "
          f"output {out_mb:.1f} MB, peak temp {temp}")
    print(f"[export]   executed OK: dets {tuple(dets.shape)}")
    return {"export_s": t1 - t0, "compile_s": t2 - t1, "flops": flops}


def load_and_run(path: str) -> torch.Tensor:
    served = load_serving(path)
    spec = input_spec(served.program)
    x = torch.zeros(spec.shape, dtype=spec.dtype, device=spec.device)
    t0 = time.perf_counter()
    dets = served(x)
    _sync(x.device)
    t1 = time.perf_counter()
    print(f"[export] {path}: ran on {x.device}, dets {tuple(dets.shape)} in "
          f"{t1 - t0:.2f}s")
    return dets


def main(argv=None):
    args = parse_args(argv)
    no_tf32()
    if args.load:
        return load_and_run(args.load)
    cfg = run_config(args.cfg, args.opts, defaults=True)
    if args.format == "aot":
        return export_aot(cfg, args.batch, args.device)
    out = args.out or os.path.join(run_dir(cfg),
                                   f"{cfg.model.name}_b{args.batch}.pt2")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    return export_artifact(cfg, args.batch, out, args.device)


if __name__ == "__main__":
    main()
