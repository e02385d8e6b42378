#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It drives ``centerpose_tpu_torch`` through its flagship paths,
dla_34 at 512x512 in bfloat16 with the committed dla_34 snapshot
(``output/dla34_hard_artifact/params_f16.npz``): serving, training and
evaluation.  It prints one flushed line per phase with the seconds it
took:

1. the card (``nvidia-smi``) and the build of the CUDA libraries (one
   ``nvcc`` per source, started together);
2. kernel check: K1 (``dcn_v2_fused``) against its plain version at the 7
   DCN site shapes of dla_34 @512, batch 1, in float32 (TF32 off) and
   bfloat16, and at batch 8 (the serving batch) in bfloat16, with offsets
   large enough to exercise the y-clamp; time per call beside the plain
   version's, the bound of the card, the bytes the call gathers (mostly
   from L2) and the bf16 launch plan (tile, split, stages, launches); K1's
   time per forward (the 16 calls) at batch 1 and 8;
3. training kernel check: K2 (``dcn_v2``) and the backward kernel
   (``dcn_v2_backward``: dx, doffset, dmask, dW, dbias) against their plain
   versions (``ops/dcn.dcn_v2`` and its autograd) on one cotangent, at the 7
   site shapes, in float32 at batch 1 and bfloat16 at batch 8 (the training
   batch), with offsets that clamp at some taps; K2's time per step (16
   calls) at batch 8;
   then a determinism check: at the 7 site shapes, batch 8, in bfloat16
   and float32, two backward calls on the same inputs give bit-equal dx,
   doffset, dmask, dW and dbias, and at batch 1 and 8 in bfloat16 two K1
   calls bit-equal y and om, two K2 calls bit-equal y (split plans among
   them); and an edge check at a 384x384 site whose
   reference backward falls back to the VJP of ``jnp.clip`` (gradient 0.5
   where |dy| is exactly R): the kernel with that edge against the plain
   version, and against itself with edge 1;
4. model check: the whole model's inference kernel path against its plain
   path on the card (head errors, overlap of the top-100 decoded centers),
   in float32 and bfloat16, and 16 K1 calls per forward (16 kernel
   launches in bfloat16, one a call; 32 in float32: the om conv and the
   product); then the ``dcn_impl: conv`` ablation (dla_34 @512 bf16 from
   seeded random weights: one forward, finite heads, no DCN kernel
   launched);
5. training model check: one training step at 512x512, batch 2, float32,
   from the snapshot, kernel path against plain path: the loss, every
   parameter's gradient and the BatchNorm statistics after the step; 16 K2
   and 16 backward launches per step; then the same in bfloat16 (tolerances
   TOL_TRAIN_BF16), with a probe of the repaired conv -> BatchNorm
   hand-off (``models/common._ConvF32``): every conv of it ran its backward
   on f32 operands with TF32 on (bf16 values read exactly), none in bf16;
6. serving, a main path: ``Detector.run`` on 4 images and
   ``Detector.run_batch`` at batch 8, with the launch counts of that run;
7. trace: one batch-8 ``run_batch`` under ``torch.profiler``, device time
   by kernel;
7b. demo, a main path: 32 synthetic 640x480 frames of the port's renderer
   (``data/synthetic.render_scene``) through the demo's batched stream
   (``tools/demo.stream``: pre-process on the card, one
   ``Detector.process`` call and one copy to the host per batch of 8, the
   inverse affine per frame), 16 K1 launches per call, 64 in all; each
   frame's 100 rows finite and held against ``Detector.run`` on the same
   frame (DEMO_PX, DEMO_SCORE); frames/s beside ``Detector.run``'s ms per
   frame; ``soft_nms_39_jit`` on the card on each frame's rows against the
   host ``soft_nms_39``, ms per call; where cv2 imports, the demo CLI on
   ``--demo synthetic`` (4 PNGs), else a line saying it was not run;
8. training, a main path: the port's ``Trainer`` at batch 8, bfloat16,
   ``pallas_full``, compact wire, on batches encoded by the port's
   ``encode_example`` (train augmentation on) from synthetic frames: one
   warm-up step, 6 timed steps on fresh batches, then 10 steps on one fixed
   batch whose loss must fall; the launch counts of that run;
9. training trace: one step under ``torch.profiler``;
10. evaluation, a main path: the hard benchmark's 512 seed-3 scenes drawn
   by the port's renderer (``data/synthetic.render_scene_hard``, in 8
   processes), the ``Detector`` (bf16, ``pallas_full``: K1) over every
   scene at single scale, then with flip and scales 0.75, 1.0, 1.25
   (soft-NMS merge), OKS AP by the port's evaluator: one line per mode
   with AP, AP50, AP75, AR, images/s, the card and the K1 launches of that
   mode; it fails unless each AP lies within 0.002 of the reference's
   (``output/hard_eval.json``: ``cross_impl.pallas_full_bf16`` and
   ``modes.ms_flip_nms``, both on the snapshot); then the ``xla`` bf16
   row (K2 at every site, no K1), printed beside the reference's
   ``cross_impl.xla_bf16``;
11. backbones (serving), a main path: each backbone with a committed
   snapshot (res_18, hrnet_w32, mobilenetv3) through the port's
   ``tools/hard_eval`` backbone config (the defaults with ``model.name``:
   float32 with TF32 off, single scale) and ``Detector.run`` over the same
   512 scenes; OKS AP within 0.002 of the reference's ``backbones`` row,
   images/s and ms per image by stage; no DCN kernel launched (these
   backbones have no hand-written kernel); res_18's ``run_batch`` at
   batch 8 in float32 and bfloat16 (images/s), the bfloat16 heads within
   TOL_BB_BF16 of the float32 ones and every confident center of either
   matched in the other (as in the model check);
12. training CLI, a main path: the port's ``tools/train.py`` ``main`` on
   the flagship config (``--synthetic --hard``, batch 8, 8 encode
   workers, 2 epochs of 8 steps, validation loss and AP on 32 images after
   each epoch), from random weights (seeded); it fails unless the run ends
   with ``log.txt``, ``scalars.jsonl``, ``model_last`` and its
   ``.meta.json`` and ``model_best``, finite train losses, K2 and the
   backward launched 16 times a step and K1 in the AP passes; a second run
   with ``train.resume 1`` starts at epoch 3 from a state bit-equal to the
   live trainer's (parameters, BatchNorm statistics, Adam's moments and
   steps, step count, schedule position) and its first loss is the live
   trainer's on the same batch, bit for bit; ``model_best`` loaded
   through ``tools/evaluate.load_detector`` on the card, its weights
   bit-equal to the file's and its ``Detector.run`` launching K1; the
   first 3 batches of an
   epoch with 8 workers equal those with none byte for byte; the native
   library is built and its encoder matches the numpy path within 1e-5
   over 64 examples.  It prints each epoch's images/s and
   ``data_wait_frac``;
13. backbones (training), a main path: res_18, hrnet_w32 and mobilenetv3
   from their snapshots.  A device check first: one step at 128x128,
   batch 2, float32 (TF32 off) on the card and on the host CPU from the
   same weights and batch, the loss, every gradient and the BatchNorm
   statistics after the step held at TOL_BB_TRAIN; then the ``Trainer`` at
   512x512, batch 8, compact wire, on batches of the port's encoder, in
   the config ``tools/train.py --defaults model.name NAME`` builds
   (float32, TF32 off) and in bfloat16: one warm-up step, 6 timed steps
   (ms per step, images/s), 10 steps on one fixed batch whose loss must
   fall, and no DCN kernel launched.

``python3 chip_smoke.py --only training`` runs the build, the training
main path and its trace alone (to compare two trees in one call).

Then it prints the kernels' JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
exit code is then not 0.  Without a CUDA device, or outside the
repository, it prints no result and exits with 1.  It writes nothing but
the kernel build directory (``centerpose_tpu_torch/build/``, git-ignored)
and the training CLI's logs and checkpoints (in a temporary directory,
removed at the end).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NPZ = ROOT / "output" / "dla34_hard_artifact" / "params_f16.npz"

# dla_34 DCN sites at 512x512 input: (Cin, Cout, H=W, calls per forward)
SITES = [(512, 256, 16, 1), (256, 256, 32, 1), (256, 128, 32, 2),
         (128, 128, 64, 2), (128, 64, 64, 4), (256, 64, 32, 1),
         (64, 64, 128, 5)]
# Published H100 SXM peaks: HBM bytes/s; dense FLOP/s by operand type
# (bf16 tensor cores; float32 outside the tensor cores).
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Tolerances, max |kernel - plain| / max |plain|:
# float32: both sum the same f32 products in a different order.
# bfloat16: both compute in f32 from the same bf16 inputs; the outputs are
# rounded to bf16 (2^-8 relative), so they may differ by an ulp or two.
TOL_K1 = {"float32": 1e-4, "bfloat16": 1e-2}
# Whole model (16 DCN sites between BN/ReLU/convs): head errors, and the
# top-100 decoded centers.  f32: the two paths must pick the same centers.
# bf16: the tail of the top-100 is low scores a rounding apart, and a peak
# may move to a neighbouring cell where two cells nearly tie, so every
# confident center (score >= 0.1) of either path must have a center of the
# other path within one cell and 0.05 in score.
TOL_HEADS = {"float32": 1e-3, "bfloat16": 5e-2}
MIN_OVERLAP_F32 = 0.98
CONFIDENT = 0.1
MATCH_SCORE = 0.05
# K2 and the backward against their plain versions, max |kernel - plain| /
# max |plain| per output.  float32: the same f32 products summed in another
# (fixed) order.  bfloat16: both compute in f32 from the same bf16
# inputs and round each output to bf16 once (an ulp is 2^-8 of a value);
# the sampled columns that dW multiplies are rounded to bf16 too, and a
# one-ulp-of-f32 difference before that rounding may move one column
# element by a bf16 ulp; the kernel's dx sums dcols rounded to bf16 (as
# the reference's K5 keeps them), the plain version's unrounded.
TOL_K2 = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_NAMES = ("dx", "doffset", "dmask", "dW", "dbias")
# Training model check (float32, 512x512, batch 2, kernel vs plain path):
# the loss; each BatchNorm statistic; each parameter's gradient by its
# relative L2 error.  The two paths differ by the kernels' f32 summation
# order (dx and dW in the kernel's fixed order), which the BatchNorms and
# ReLUs between the
# 16 sites carry upstream: the worst tensor read 1.72e-4 on an H100 (median
# 2.69e-5).  A site whose backward is wrong by a percent or more moves that
# site's own tensors by as much, ten times the limit.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_STATS = 1e-4
TOL_TRAIN_GRAD_L2 = 1e-3
TRAIN_BATCH = 8  # bench.py's train_batch
# The bfloat16 training step, kernel path against plain path (same weights
# and batch): both round each DCN output, conv and BatchNorm output to
# bf16 at the same points and differ in the f32 sums of K2 and of the
# backward kernels, which move a value across a bf16 rounding boundary
# now and then; the 16 sites and the depth carry that to every tensor.
# The loss and the BatchNorm statistics (max rel) read 8.5e-5 and 2.6e-5
# on an H100; the gradients are held by their relative L2 over the whole
# model and the median of the tensors' (per tensor the worst is a bias
# gradient that sums cancelling terms: hp_offset_out.bias at 0.19, the
# median 1.4e-2).
TOL_TRAIN_BF16 = {"loss": 1e-3, "stats": 1e-3, "grad_l2": 5e-2}
# The backbones' training device check: float32 with TF32 off, one step
# at 128x128, batch 2, the card's cuDNN against the host CPU's oneDNN
# convs (another summation order); max rel for the loss and the
# statistics, relative L2 of all the gradients together and the median of
# the tensors' for the gradients (per tensor, hrnet_w32's worst, a
# BatchNorm bias deep in branch 1, read 3.4e-3 with a median of 1.7e-4 on
# an H100).
TOL_BB_TRAIN = {"loss": 1e-4, "stats": 1e-3, "grad_l2": 1e-3}
BB_TRAIN_RES, BB_TRAIN_STEPS, BB_FIT_STEPS = 512, 6, 10
# Evaluation: the hard benchmark (512 scenes of seed 3), OKS AP of the
# bf16 pallas_full Detector against the reference's AP on the same
# snapshot, read from its results file at run time.  0.002 is ROADMAP's
# main-path acceptance: the reference's own bf16 rows differ by 0.0008
# (xla against pallas_full).
EVAL_N = 512
EVAL_RENDER_WORKERS = 8
ANCHORS = ROOT / "output" / "hard_eval.json"
TOL_AP = 0.002
# The modes whose AP is gated at TOL_AP against the reference's row.  The
# xla bf16 row is printed: bf16 rows move by up to 0.004 AP with the
# convs' summation order alone, and on an H100 it reads 0.0045 below the
# reference's (PERF.md, section 6).
GATED_MODES = ("single", "ms_flip_nms")
# The backbones with a committed snapshot (factory name -> artifact), each
# gated at TOL_AP against the reference's ``backbones`` row: single scale,
# float32 (TF32 off), on the same 512 scenes.
BACKBONES = {"res_18": "res18", "hrnet_w32": "hrnet32",
             "mobilenetv3": "mbv3"}
BACKBONE_BATCH = 8
# res_18's bfloat16 run_batch against its float32 one on the same frames:
# max |bf16 - f32| / max |f32| per head (the reference's own bf16-to-f32
# distance on this snapshot is 3.4e-3 to 8.4e-3 at 128x128 on a CPU, the
# port's 4.5e-3 to 5.9e-3 on four hard scenes at 256x256), and the
# confident centers matched as in the model check (CONFIDENT, one cell,
# MATCH_SCORE).
TOL_BB_BF16 = 2e-2
# The training CLI phase: the port's tools/train.py main() on the flagship
# config at batch 8 with 8 encode workers, 2 epochs of 8 steps, validation
# (loss and AP on 32 images) after each, then a resume for a third epoch.
CLI_STEPS, CLI_EPOCHS, CLI_WORKERS, CLI_AP_LIMIT = 8, 2, 8, 32
# The native encoder against the numpy path: the reference's own tolerance
# (tests/test_native.py), over this many examples.
NATIVE_EXAMPLES, TOL_NATIVE = 64, 1e-5
# The demo phase: 32 synthetic 640x480 frames through the demo's batched
# stream at batch 8, each frame's rows held against Detector.run on the
# same frame (batch 1: K1 and cuDNN may take other plans, so the bf16 rows
# may differ in their last bits): every row scoring >= test.vis_thresh on
# either side has a row on the other within DEMO_PX image pixels (box
# center, Chebyshev) and DEMO_SCORE in score, about 12x and 3x the
# worst read on the H100 (0.020 px, 0.0037): a frame whose inverse affine
# is off by a pixel fails.  The on-device soft-NMS on
# each frame's rows against the host soft_nms_39, score by score (the
# reference's own check): DEMO_NMS_RTOL relative, DEMO_NMS_ATOL absolute.
DEMO_FRAMES, DEMO_BATCH = 32, 8
DEMO_PX, DEMO_SCORE = 0.25, 0.01
DEMO_NMS_RTOL, DEMO_NMS_ATOL = 1e-4, 1e-7


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, fn):
    say(f"[phase] {name}: start")
    t0 = time.perf_counter()
    out = fn()
    say(f"[phase] {name}: done in {time.perf_counter() - t0:.2f} s")
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, after
    one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound(b: int, hw: int, cin: int, cout: int, dtype: str):
    """(bound ms, 'bytes' | 'operations') of one K1 call: inputs read once,
    output written once; main product + om conv at the peak of the type."""
    elem = 4 if dtype == "float32" else 2
    npix = b * hw * hw
    nbytes = elem * (npix * cin + 9 * cin * cout + cout + 9 * cin * 27 + 27
                     + npix * cout)
    flops = 2.0 * npix * 9 * cin * (cout + 27)
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def gather_bytes(b: int, hw: int, cin: int, fused: bool) -> float:
    """Bytes one bf16 call gathers (mostly from L2, some from L1): four
    corners of every (pixel, tap, channel) for the product, one for K1's
    om conv.  Beside the bound, not in it (the bound counts each input
    once)."""
    return 2.0 * b * hw * hw * 9 * cin * (4 + (1 if fused else 0))


def plan_text(dtype, b: int, hw: int, cin: int, cout: int) -> str:
    from centerpose_tpu_torch.ops import dcn_cuda as dc

    p = dc.forward_plan(dtype, b, hw, hw, cin, cout)
    if p["kernel"] != "wgmma":
        return f"plan {p['kernel']} launches {p['launches']}"
    return (f"plan tile {p['tile_m']}x{p['n_pad']} split {p['split']} "
            f"stages {p['stages']} smem {p['smem']} grid {p['grid'][0]} "
            f"launches {p['launches']}")


def k1_inputs(seed: int, b: int, hw: int, cin: int, cout: int):
    """Random x and weights; om weights scaled so that the offsets have a
    std of about 12 cells, so that |dy| exceeds every site's clamp R at
    many taps."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    x = r.normal(size=(b, hw, hw, cin))
    omw = r.normal(size=(3, 3, cin, 27)) * (12.0 / np.sqrt(9 * cin))
    omb = r.normal(size=(27,))
    w = r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
    bias = r.normal(size=(cout,))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, omw, omb, w, bias)]


def on_card(base, dt):
    """x and the weights in ``dt`` on the card; the bias stays float32."""
    import torch

    return [t.to("cuda", dt if i < 4 else torch.float32).contiguous()
            for i, t in enumerate(base)]


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def build():
    from centerpose_tpu_torch.ops import dcn_cuda

    for name, so in dcn_cuda.build_library().items():
        log = so.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
        say(f"  library: {so.relative_to(ROOT)}")


def kernel_check():
    """K1 against its plain version at every site shape; returns the JSON
    entries (bf16, the flagship dtype) keyed by site."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain

    entries = {}
    per_fwd = {1: 0.0, 8: 0.0}  # bf16 K1 ms per forward (16 calls)
    calls = {(cin, cout, hw): n for cin, cout, hw, n in SITES}
    cases = [(cin, cout, hw, dc.site_max_dy(hw, hw, cin, cout, "pallas_full"))
             for cin, cout, hw, _ in SITES]
    check([c[3] for c in cases] == [24, 12, 12, 12, 12, 12, 6],
          f"site policy at 512: {[c[3] for c in cases]}")
    cases.append((64, 64, 128, None))  # an unclamped site (the xla policy)
    for i, (cin, cout, hw, r) in enumerate(cases):
        base = k1_inputs(100 + i, 1, hw, cin, cout)
        for dtype in ("float32", "bfloat16"):
            args = on_card(base, getattr(torch, dtype))
            got = dc.dcn_v2_fused(*args, r)
            ref = dcn_v2_fused_plain(*args, r)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K1 output not finite")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = err / max(scale, 1e-12)
            clamped = 0.0
            if r is not None:
                om = torch.nn.functional.conv2d(
                    args[0].float().permute(0, 3, 1, 2),
                    args[1].float().permute(3, 2, 0, 1), args[2].float(),
                    padding=1)
                clamped = (om[:, 0:18:2].abs() > r).float().mean().item()
                check(clamped > 0.01, f"clamp not exercised at R={r}")
            ms = cuda_ms(lambda: dc.dcn_v2_fused(*args, r), 20)
            plain_ms = cuda_ms(lambda: dcn_v2_fused_plain(*args, r), 5)
            bound_ms, bound_by = k1_bound(1, hw, cin, cout, dtype)
            say(f"  K1 {cin}->{cout} @{hw}x{hw} R={r} {dtype}: "
                f"max_abs_err {err:.3e} (rel {rel:.2e}, tol "
                f"{TOL_K1[dtype]:.0e}; |dy|>R at {clamped:.1%} of taps) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"bound {bound_ms:.5f} ms ({bound_by}); gathers "
                f"{gather_bytes(1, hw, cin, True) / 1e6:.1f} MB; "
                + plan_text(getattr(torch, dtype), 1, hw, cin, cout))
            if dtype == "bfloat16" and r is not None:
                per_fwd[1] += calls[(cin, cout, hw)] * ms
            check(rel <= TOL_K1[dtype],
                  f"K1 {cin}->{cout} @{hw} {dtype}: rel err {rel:.3e}")
            if dtype == "bfloat16" and r is not None:
                entries[(cin, cout, hw, hw)] = {
                    "name": f"dcn_v2_fused {cin}->{cout} @{hw}x{hw} b1",
                    "route": "cuda",
                    "source": "centerpose_tpu_torch/csrc/dcn_fused.cu",
                    "replaces": ("centerpose_tpu/ops/dcn_pallas.py:650"
                                 if hw == 128 else
                                 "centerpose_tpu/ops/dcn_pallas.py:735"),
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None}
        # batch 8, the shapes the serving batch gives the kernel
        args = on_card(k1_inputs(200 + i, 8, hw, cin, cout), torch.bfloat16)
        got = dc.dcn_v2_fused(*args, r)
        ref = dcn_v2_fused_plain(*args, r)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "K1 batch-8 output not finite")
        err8 = (got.float() - ref.float()).abs().max().item()
        rel8 = err8 / max(ref.float().abs().max().item(), 1e-12)
        del got, ref
        ms8 = cuda_ms(lambda: dc.dcn_v2_fused(*args, r), 10)
        plain8 = cuda_ms(lambda: dcn_v2_fused_plain(*args, r), 3)
        bound8, by8 = k1_bound(8, hw, cin, cout, "bfloat16")
        say(f"  K1 {cin}->{cout} @{hw}x{hw} R={r} bfloat16 batch 8: "
            f"max_abs_err {err8:.3e} (rel {rel8:.2e}, tol "
            f"{TOL_K1['bfloat16']:.0e}) kernel {ms8:.4f} ms "
            f"plain {plain8:.4f} ms bound {bound8:.5f} ms ({by8}); gathers "
            f"{gather_bytes(8, hw, cin, True) / 1e6:.1f} MB; "
            + plan_text(torch.bfloat16, 8, hw, cin, cout))
        if r is not None:
            per_fwd[8] += calls[(cin, cout, hw)] * ms8
        check(rel8 <= TOL_K1["bfloat16"],
              f"K1 {cin}->{cout} @{hw} bfloat16 batch 8: rel err {rel8:.3e}")
    say(f"  K1 bfloat16 per forward (16 calls, sum of the site times): "
        f"batch 1 {per_fwd[1]:.4f} ms, batch 8 {per_fwd[8]:.4f} ms")
    return entries


def scene(seed: int, h: int = 480, w: int = 640):
    """A synthetic RGB uint8 frame: smooth background and a few bright
    ellipses, made with numpy from ``seed``."""
    import numpy as np

    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 40 * np.sin(xx / 97.0 + c) * np.cos(yy / 71.0 - c)
                    for c in range(3)], -1)
    for _ in range(4):
        cy, cx = r.uniform(0.2, 0.8) * h, r.uniform(0.2, 0.8) * w
        ry, rx = r.uniform(0.15, 0.35) * h, r.uniform(0.04, 0.1) * w
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[inside] = r.uniform(120, 250, size=3)
    img += r.normal(0, 4, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def flagship_cfg():
    """experiments/dla_34_512x512.yaml, built in code (no yaml needed),
    with its train block (Adam at 1.25e-4, compact wire) at batch 8."""
    from centerpose_tpu_torch.config import flagship_config, update_config

    return update_config(flagship_config(),
                         {"train": {"batch_size": TRAIN_BATCH}})


def model_check(state_dict):
    import numpy as np
    import torch

    from centerpose_tpu_torch.losses import sigmoid_clamped
    from centerpose_tpu_torch.models import dla
    from centerpose_tpu_torch.models.common import (to_channels_last,
                                                    to_compute_dtype)
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain
    from centerpose_tpu_torch.ops.decode import multi_pose_decode
    from centerpose_tpu_torch.ops.nms import heat_nms, topk
    from centerpose_tpu_torch.weights import load_state_dict

    cfg = flagship_cfg()
    model = create_model(cfg)
    load_state_dict(model, state_dict)
    model = to_channels_last(model.to("cuda")).eval()
    mean = np.asarray(cfg.dataset.mean, np.float32)
    std = np.asarray(cfg.dataset.std, np.float32)
    imgs = np.stack([scene(s, 512, 512) for s in (1, 2)])
    x = torch.from_numpy((imgs.astype(np.float32) / 255.0 - mean) / std)
    x = x.to("cuda")
    for dtype in ("float32", "bfloat16"):
        model = to_compute_dtype(model, getattr(torch, dtype))
        with torch.inference_mode():
            dc.reset_launch_counts()
            out_k = model(x)
            torch.cuda.synchronize()
            launches = dc.dcn_v2_fused.launches
            by_site = dict(dc.dcn_v2_fused.launches_by_site)
            # the plain path: every DCN site calls the plain version
            dla.dcn_v2_fused = dcn_v2_fused_plain
            try:
                out_p = model(x)
            finally:
                dla.dcn_v2_fused = dc.dcn_v2_fused
            torch.cuda.synchronize()
        per_call = dc.KERNELS_PER_CALL[getattr(torch, dtype)]
        check(launches == 16 * per_call,
              f"K1 kernel launches per forward: {launches}")
        want = {(cin, cout, hw, hw): n * per_call
                for cin, cout, hw, n in SITES}
        check(by_site == want, f"K1 launches by site: {by_site}")
        errs = {}
        for name in out_k:
            a, b = out_k[name], out_p[name]
            check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                  f"head {name}: {tuple(a.shape)} finite "
                  f"{bool(torch.isfinite(a).all())}")
            errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        hk = heat_nms(sigmoid_clamped(out_k["hm"]))
        hp = heat_nms(sigmoid_clamped(out_p["hm"]))
        sk, ik, _, _, _ = topk(hk, 100)
        sp, ip, _, _, _ = topk(hp, 100)
        overlap = min(len(set(ik[i].tolist()) & set(ip[i].tolist())) / 100.0
                      for i in range(ik.shape[0]))
        n_conf, unmatched, worst = match_confident(
            sk.cpu().numpy(), ik.cpu().numpy(), sp.cpu().numpy(),
            ip.cpu().numpy(), hk.shape[2])
        dets = multi_pose_decode(
            sigmoid_clamped(out_k["hm"]), out_k["wh"], out_k["hps"],
            out_k["reg"], sigmoid_clamped(out_k["hm_hp"]),
            out_k["hp_offset"], k=100)
        check(tuple(dets.shape) == (2, 100, 40)
              and bool(torch.isfinite(dets).all()), "decode output")
        say(f"  model {dtype} 512x512 batch 2: K1 kernel launches/forward "
            f"{launches} ({launches // per_call} calls); "
            "head rel err kernel vs plain "
            + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
            + f"; top-100 center overlap {overlap:.2f}; {n_conf} centers "
            f"score >= {CONFIDENT}, {unmatched} unmatched, worst score "
            f"diff {worst:.4f}; top score {sp.max().item():.4f}")
        check(max(errs.values()) <= TOL_HEADS[dtype],
              f"model {dtype}: head rel err {errs}")
        check(n_conf >= 1, f"model {dtype}: no center scores >= {CONFIDENT}")
        check(unmatched == 0, f"model {dtype}: {unmatched} of {n_conf} "
              "confident centers have no match in the other path")
        if dtype == "float32":
            check(overlap >= MIN_OVERLAP_F32,
                  f"model {dtype}: top-100 overlap {overlap}")


def conv_ablation_check() -> None:
    """dla_34 @512 bf16 under the ``conv`` ablation from seeded random
    weights: one forward with finite heads, and no DCN kernel launched."""
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.models.common import (to_channels_last,
                                                    to_compute_dtype)
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.ops import dcn_cuda as dc

    cfg = update_config(flagship_cfg(), {"model": {"dcn_impl": "conv"}})
    torch.manual_seed(0)
    model = to_compute_dtype(to_channels_last(create_model(cfg).to("cuda")),
                             torch.bfloat16).eval()
    x = torch.randn(2, 512, 512, 3, generator=torch.Generator().manual_seed(1))
    dc.reset_launch_counts()
    with torch.inference_mode():
        out = model(x.to("cuda"))
    torch.cuda.synchronize()
    n = sum(fn.launches for fn in dc.COUNTED)
    for name, v in out.items():
        check(bool(torch.isfinite(v).all()), f"conv ablation: head {name}")
    check(n == 0, f"conv ablation: {n} DCN kernel launches")
    say(f"  model bfloat16 512x512 batch 2, dcn_impl conv (seeded random "
        f"weights): heads finite, DCN kernel launches {n}")
    del model, out


def match_confident(sa, ia, sb, ib, width: int):
    """Centers scoring >= CONFIDENT in either of two top-K lists (scores
    [B, K], flat y*W+x indices [B, K]) that find no center of the other
    list within one cell (Chebyshev) and MATCH_SCORE in score.  Returns
    (confident centers counted, unmatched, worst score difference of the
    matched ones)."""
    import numpy as np

    n = unmatched = 0
    worst = 0.0
    for i in range(sa.shape[0]):
        for s1, i1, s2, i2 in ((sa[i], ia[i], sb[i], ib[i]),
                               (sb[i], ib[i], sa[i], ia[i])):
            y2, x2 = i2 // width, i2 % width
            for score, ind in zip(s1, i1):
                if score < CONFIDENT:
                    continue
                n += 1
                near = np.maximum(np.abs(y2 - ind // width),
                                  np.abs(x2 - ind % width)) <= 1
                diff = np.abs(s2[near] - score).min() if near.any() else 1.0
                if diff > MATCH_SCORE:
                    unmatched += 1
                else:
                    worst = max(worst, float(diff))
    return n, unmatched, worst


def det_cells(dets, width: int):
    """Scores [B, K] and flat y*W+x center cells [B, K] of decoded
    detections [B, K, 40] (grid coordinates; the box center is the peak's
    cell plus its sub-cell offset)."""
    import numpy as np

    cx = np.clip(np.floor((dets[..., 0] + dets[..., 2]) / 2), 0, width - 1)
    cy = np.floor((dets[..., 1] + dets[..., 3]) / 2).clip(0)
    return dets[..., 4], (cy * width + cx).astype(np.int64)


def serving(state_dict):
    """The main path: Detector.run on 4 frames, then run_batch at batch 8.
    Returns the K1 launch counts by site of this run."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.ops import dcn_cuda as dc

    det = Detector(flagship_cfg(), state_dict, device="cuda")
    frames = [scene(10 + i) for i in range(8)]
    det.run(frames[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    dc.reset_launch_counts()
    for i in range(4):
        ret = det.run(frames[i])
        res = ret["results"][1]
        check(res.shape == (100, 39) and np.isfinite(res).all(),
              f"run: results {res.shape}")
        say(f"  run image {i}: pre {ret['pre'] * 1e3:.2f} ms net "
            f"{ret['net'] * 1e3:.2f} ms post {ret['post'] * 1e3:.2f} ms "
            f"top score {res[0, 4]:.4f}")
    batch = torch.cat([det.pre_process(f)[0] for f in frames]).cpu().numpy()
    dets = det.run_batch(batch)
    torch.cuda.synchronize()
    n_iter = 3
    t0 = time.perf_counter()
    for _ in range(n_iter):
        dets = det.run_batch(batch)
    dt = time.perf_counter() - t0
    launches = dict(dc.dcn_v2_fused.launches_by_site)
    total = dc.dcn_v2_fused.launches
    forwards = 4 + 1 + n_iter
    check(total == 16 * dc.KERNELS_PER_CALL[torch.bfloat16] * forwards,
          f"K1 kernel launches {total} for {forwards} forwards")
    check(dets.shape == (8, 100, 40) and np.isfinite(dets).all(),
          f"run_batch: {dets.shape}")
    single = det.process(torch.from_numpy(batch[:1]).cuda()).cpu().numpy()
    # the same frame alone and in the batch of 8: cuDNN may pick other conv
    # algorithms per batch size, so in bf16 the scores (probabilities) may
    # move by the bf16 head error times the sigmoid's slope
    diff = np.abs(np.sort(single[0, :, 4]) - np.sort(dets[0, :, 4])).max()
    check(diff <= 5e-2, f"batch-8 vs batch-1 scores differ by {diff}")
    say(f"  run_batch batch 8: {8 * n_iter / dt:.2f} images/s "
        f"({dt / n_iter * 1e3:.2f} ms per batch, host clock, synchronised); "
        f"score diff vs batch 1 {diff:.2e}")
    return launches, det, batch


def match_rows(a, b, thresh: float):
    """Rows [K, 39] of one frame from two runs: (rows scoring >= thresh on
    either side, those without a row on the other side within DEMO_PX
    pixels of box center and DEMO_SCORE in score, the worst center distance
    and score difference of the matched ones)."""
    import numpy as np

    n = unmatched = 0
    worst_px = worst_score = 0.0
    for s1, s2 in ((a, b), (b, a)):
        c2 = (s2[:, 0:2] + s2[:, 2:4]) / 2
        for row in s1[s1[:, 4] >= thresh]:
            n += 1
            px = np.abs(c2 - (row[0:2] + row[2:4]) / 2).max(1)
            ds = np.abs(s2[:, 4] - row[4])
            ok = (px <= DEMO_PX) & (ds <= DEMO_SCORE)
            if not ok.any():
                unmatched += 1
                continue
            j = np.flatnonzero(ok)[np.argmin(ds[ok])]
            worst_px = max(worst_px, float(px[j]))
            worst_score = max(worst_score, float(ds[j]))
    return n, unmatched, worst_px, worst_score


def demo(state_dict, card: str, device: str = "cuda"):
    """The demo main path: the flagship Detector over DEMO_FRAMES synthetic
    frames through ``tools/demo.stream`` at batch DEMO_BATCH, held against
    ``Detector.run``; ``soft_nms_39_jit`` on the card against the host
    soft-NMS; the demo CLI on ``synthetic`` where cv2 imports.  Returns the
    K1 launch counts by site of the stream's run."""
    import tempfile

    import numpy as np
    import torch

    from centerpose_tpu_torch.data.synthetic import render_scene
    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.soft_nms import soft_nms_39, soft_nms_39_jit
    from centerpose_tpu_torch.tools import demo as demo_cli

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    cfg = flagship_cfg()
    det = Detector(cfg, state_dict, device=device)
    frames = [render_scene(np.random.default_rng(300 + i), 640, 480, 2)[0]
              for i in range(DEMO_FRAMES)]
    list(demo_cli.stream(det, frames[:DEMO_BATCH], DEMO_BATCH))  # warm-up
    sync()
    dc.reset_launch_counts()
    t0 = time.perf_counter()
    streamed = list(demo_cli.stream(det, frames, DEMO_BATCH))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(dc.dcn_v2_fused.launches_by_site)
    total = dc.dcn_v2_fused.launches
    calls = -(-DEMO_FRAMES // DEMO_BATCH)
    per_call = dc.KERNELS_PER_CALL[torch.bfloat16]
    check(total == 16 * per_call * calls,
          f"demo stream: K1 launches {total} for {calls} process calls")
    want = {(cin, cout, hw, hw): n * per_call * calls
            for cin, cout, hw, n in SITES}
    check(launches == want, f"demo stream: K1 launches by site {launches}")
    check(len(streamed) == DEMO_FRAMES
          and all(f is g for (f, _), g in zip(streamed, frames)),
          "demo stream: frames out of order")
    # where the stream's time goes: the per-frame pre-process alone, then
    # the batch-8 forward and decode alone (host clock, synchronised)
    t0 = time.perf_counter()
    pre = [det.pre_process(f)[0] for f in frames]
    sync()
    pre_ms = (time.perf_counter() - t0) * 1e3
    batch = torch.cat(pre[:DEMO_BATCH])
    t0 = time.perf_counter()
    for _ in range(calls):
        det.process(batch)
    sync()
    net_ms = (time.perf_counter() - t0) * 1e3
    del pre, batch
    for i, (_, rows) in enumerate(streamed):
        check(rows.shape == (100, 39) and bool(np.isfinite(rows).all()),
              f"demo stream frame {i}: rows {rows.shape}")
    # the same frames one at a time through Detector.run
    run_ms = []
    n_conf = unmatched = 0
    worst_px = worst_score = 0.0
    for i, (frame, rows) in enumerate(streamed):
        ret = det.run(frame)
        run_ms.append(ret["tot"] * 1e3)
        n, u, px, ds = match_rows(rows, ret["results"][1],
                                  cfg.test.vis_thresh)
        n_conf += n
        unmatched += u
        worst_px, worst_score = max(worst_px, px), max(worst_score, ds)
    say(f"  demo stream: {DEMO_FRAMES} frames 640x480 at batch {DEMO_BATCH} "
        f"({calls} process calls) in {wall * 1e3:.2f} ms: "
        f"{DEMO_FRAMES / wall:.2f} frames/s (host clock, synchronised); "
        f"Detector.run {np.mean(run_ms):.2f} ms per frame (median "
        f"{np.median(run_ms):.2f}); K1 launches {total} "
        f"({total // calls} per call); alone: pre-process {pre_ms:.2f} ms "
        f"for the {DEMO_FRAMES} frames, {calls} batch-8 process calls "
        f"{net_ms:.2f} ms; {card}")
    say(f"  demo rows vs Detector.run: {n_conf} rows score >= "
        f"{cfg.test.vis_thresh} on either side, {unmatched} unmatched, worst "
        f"center {worst_px:.3f} px, worst score diff {worst_score:.4f} "
        f"(limits {DEMO_PX} px, {DEMO_SCORE})")
    check(n_conf >= DEMO_FRAMES, f"demo: only {n_conf} confident rows")
    check(unmatched == 0, f"demo: {unmatched} of {n_conf} confident rows "
          "have no match in Detector.run's")

    # the fixed-K soft-NMS on the card against the host's, by row identity
    rows = torch.stack([torch.from_numpy(r) for _, r in streamed]).to(device)
    soft_nms_39_jit(rows[0], thresh=0.0)  # warm-up
    sync()
    t0 = time.perf_counter()
    got = [soft_nms_39_jit(rows[i], thresh=0.0) for i in range(DEMO_FRAMES)]
    sync()
    nms_ms = (time.perf_counter() - t0) / DEMO_FRAMES * 1e3
    worst = 0.0
    n_rows = n_scored = 0
    for i, (_, r) in enumerate(streamed):
        dev = got[i].cpu().numpy()
        check(dev.shape == (100, 39) and bool(np.isfinite(dev).all()),
              f"soft_nms_39_jit frame {i}: {dev.shape}")
        check(np.array_equal(np.delete(dev, 4, 1), np.delete(r, 4, 1)),
              f"soft_nms_39_jit frame {i}: rows moved or changed")
        # the host keeps the rows scoring above 0 (the decode's zero-score
        # fill rows drop out), each with its decayed score
        host = soft_nms_39(r, method=2, thresh=0.0)
        by_row = {np.delete(h, 4).tobytes(): h[4] for h in host}
        n_scored += int((r[:, 4] > 0).sum())
        for d in dev:
            want = by_row.get(np.delete(d, 4).tobytes())
            if want is None:
                continue
            n_rows += 1
            err = abs(float(d[4]) - float(want))
            worst = max(worst, err / max(abs(float(want)), 1e-30))
            check(err <= DEMO_NMS_RTOL * abs(float(want)) + DEMO_NMS_ATOL,
                  f"soft_nms_39_jit frame {i}: score {d[4]} against the "
                  f"host's {want}")
    check(n_rows == n_scored > 0, f"soft_nms_39_jit: {n_rows} rows matched "
          f"the host's of {n_scored} scoring above 0")
    say(f"  soft_nms_39_jit [100, 39] on the card: {nms_ms:.3f} ms per call "
        f"(host clock, synchronised, {DEMO_FRAMES} calls, thresh 0); "
        f"{n_rows} rows against the host soft_nms_39, worst rel score diff "
        f"{worst:.2e}; "
        f"{card}")

    # the demo CLI draws with cv2, which this machine may lack
    try:
        import cv2  # noqa: F401
    except ImportError:
        say("  demo CLI --demo synthetic: not run, cv2 does not import here "
            "(the drawing is host code; the device path above ran)")
        return launches
    with tempfile.TemporaryDirectory(prefix="cp_demo_") as tmp:
        out = demo_cli.main(["--demo", "synthetic", "--out", tmp,
                             "--device", device])
        names = [f"synthetic_{i}" for i in range(4)]
        check(out == {"images": names}, f"demo CLI: {out}")
        for name in names:
            img = cv2.imread(str(Path(tmp) / f"{name}.png"))
            check(img is not None and img.shape == (480, 640, 3),
                  f"demo CLI wrote no {name}.png")
        say(f"  demo CLI --demo synthetic: wrote {len(names)} PNGs")
    return launches


def device_rows(prof):
    """(ms, count, name) of the device-side events of a profile, largest
    first: kernels and copies.  An operator's own device time repeats its
    kernels', and a user annotation spans them (``torch.optim`` marks each
    step as ``Optimizer.step#Adam.step``), so neither is counted."""
    import torch

    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")), reverse=True)


def trace(det, batch):
    """One traced ``run_batch`` at batch 8 (after the timed ones): device
    time by kernel, K1's share of it, and the device's idle share of the
    traced wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.run_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    check(bool(rows), "serving trace: the profiler recorded no device time")
    busy = sum(r[0] for r in rows)
    k1 = sum(r[0] for r in rows if "dcn_" in r[2])
    say(f"  trace batch 8: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"wall (idle {1 - busy / wall_ms:.1%}); K1 kernels {k1:.3f} ms "
        f"({k1 / busy:.1%} of busy)")
    for ms, count, key in rows[:12]:
        say(f"    {ms:9.3f} ms {count:4d}x {key[:90]}")


def train_bounds(b: int, hw: int, cin: int, cout: int, dtype: str):
    """((bound ms, by) of one K2 call, (bound ms, by) of one backward call):
    inputs read once and outputs written once in their dtypes; the
    products at the peak of the type (forward 2 P 9 Cin Cout operations,
    backward twice that: dcols and dW)."""
    elem = 4 if dtype == "float32" else 2
    npix = b * hw * hw
    prod = 2.0 * npix * 9 * cin * cout
    fwd_bytes = elem * (npix * (cin + 18 + 9 + cout) + 9 * cin * cout) + 4 * cout
    # in: x, offset, mask, weight, ct; out: dx, doffset, dmask, dW (input
    # dtypes), dbias (f32)
    bwd_bytes = (elem * (2 * npix * (cin + 18 + 9) + 2 * 9 * cin * cout
                         + npix * cout) + 4 * cout)
    out = []
    for nbytes, flops in ((fwd_bytes, prod), (bwd_bytes, 2 * prod)):
        t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
        out.append((max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes > t_ops else "operations"))
    return out


def k2_inputs(seed: int, b: int, hw: int, cin: int, cout: int, r):
    """x, offset, mask (sigmoid-ed), weight, bias, cotangent.  Offsets of
    std 1.5 R (R: the site's clamp radius), so that |dy| > R at many
    taps."""
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    x = g.normal(size=(b, hw, hw, cin))
    off = g.normal(size=(b, hw, hw, 18)) * 1.5 * (r or 4)
    mask = 1.0 / (1.0 + np.exp(-g.normal(size=(b, hw, hw, 9))))
    w = g.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
    bias = g.normal(size=(cout,))
    ct = g.normal(size=(b, hw, hw, cout))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, off, mask, w, bias, ct)]


def train_kernel_check():
    """K2 and the backward kernel against their plain versions at every
    site shape: float32 and bfloat16 at batch 1, bfloat16 at batch 8.
    Returns the JSON entries (bfloat16 batch 8, the training shapes) keyed
    by (kernel, site)."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2, dcn_v2_backward_plain

    entries = {}
    k2_step = 0.0  # bf16 K2 ms per batch-8 step (16 calls)
    rs = [dc.train_site_max_dy(hw, hw, cin, cout, "pallas_full")
          for cin, cout, hw, _ in SITES]
    check(rs == [24, 12, 12, 12, 12, 12, 6], f"training site policy: {rs}")
    # at 512 every site takes the reference's backward kernels (K3 or K4+K5),
    # whose clamp passes the full gradient at exactly +-R
    edges = [dc.train_site_edge_grad(hw, hw, cin, cout, "pallas_full")
             for cin, cout, hw, _ in SITES]
    check(edges == [1.0] * 7, f"training edge gradients at 512: {edges}")
    for i, ((cin, cout, hw, n_calls), r) in enumerate(zip(SITES, rs)):
        for dtype, b in (("float32", 1), ("bfloat16", 1),
                         ("bfloat16", TRAIN_BATCH)):
            dt = getattr(torch, dtype)
            x, off, mask, w, bias, ct = [
                t.to("cuda", dt if j != 4 else torch.float32).contiguous()
                for j, t in enumerate(k2_inputs(300 + i, b, hw, cin, cout, r))]
            # bf16 offsets land exactly on +-R at some taps: the kernel
            # and torch.clamp both pass the gradient there (inclusive)
            on_r = int((off[..., 0::2].float().abs() == r).sum().item())
            clamped = (off[..., 0::2].float().abs() > r).float().mean().item()
            check(clamped > 0.05, f"clamp not exercised at R={r}")
            y = dc.dcn_v2(x, off, mask, w, bias, r)
            y_ref = dcn_v2(x, off, mask, w, bias, r)
            grads = dc.dcn_v2_backward(x, off, mask, w, ct, r)
            grads_ref = dcn_v2_backward_plain(x, off, mask, w, ct, r)
            torch.cuda.synchronize()
            errs = {}
            for name, a, ref in (("y", y, y_ref),
                                 *zip(GRAD_NAMES, grads, grads_ref)):
                check(a.shape == ref.shape and a.dtype == ref.dtype
                      and bool(torch.isfinite(a).all()),
                      f"{name}: {tuple(a.shape)} {a.dtype} finite "
                      f"{bool(torch.isfinite(a).all())}")
                err = (a.float() - ref.float()).abs().max().item()
                errs[name] = (err, err / max(ref.float().abs().max().item(),
                                             1e-12))
            del y, y_ref, grads, grads_ref
            n_fwd, n_bwd = (20, 10) if b == 1 else (10, 5)
            ms = cuda_ms(lambda: dc.dcn_v2(x, off, mask, w, bias, r), n_fwd)
            plain_ms = cuda_ms(lambda: dcn_v2(x, off, mask, w, bias, r), 3)
            bwd_ms = cuda_ms(
                lambda: dc.dcn_v2_backward(x, off, mask, w, ct, r), n_bwd)
            bwd_plain_ms = cuda_ms(
                lambda: dcn_v2_backward_plain(x, off, mask, w, ct, r), 3)
            (fb, fby), (bb, bby) = train_bounds(b, hw, cin, cout, dtype)
            say(f"  K2 {cin}->{cout} @{hw}x{hw} R={r} {dtype} batch {b} "
                f"(|dy|>R at {clamped:.1%} of taps, |dy|=R at {on_r}): "
                f"fwd kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms bound {fb:.5f} ms ({fby}); bwd "
                f"kernel {bwd_ms:.4f} ms plain {bwd_plain_ms:.4f} ms bound "
                f"{bb:.5f} ms ({bby}); max_abs_err (rel) "
                + " ".join(f"{k} {e:.3e} ({q:.1e})"
                           for k, (e, q) in errs.items())
                + f"; fwd gathers {gather_bytes(b, hw, cin, False) / 1e6:.1f}"
                f" MB; fwd " + plan_text(dt, b, hw, cin, cout))
            for name, (_, rel) in errs.items():
                tol = (TOL_K2 if name == "y" else TOL_BWD)[dtype]
                check(rel <= tol, f"{name} {cin}->{cout} @{hw} {dtype}: rel "
                      f"err {rel:.3e} > {tol:.0e}")
            if b != TRAIN_BATCH:
                continue
            k2_step += n_calls * ms
            site = (cin, cout, hw, hw)
            wide = hw == 128
            entries[("dcn_v2", site)] = {
                "name": f"dcn_v2 (K2) {cin}->{cout} @{hw}x{hw} b{b}",
                "route": "cuda",
                "source": "centerpose_tpu_torch/csrc/dcn_fused.cu",
                "replaces": ("centerpose_tpu/ops/dcn_pallas.py:222" if wide
                             else "centerpose_tpu/ops/dcn_pallas.py:561"),
                "launches": 0, "max_abs_err": errs["y"][0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": fb, "bound_by": fby,
                "library_ms": None}
            entries[("dcn_v2_backward", site)] = {
                "name": f"dcn_v2_backward {cin}->{cout} @{hw}x{hw} b{b}",
                "route": "cuda",
                "source": "centerpose_tpu_torch/csrc/dcn_bwd.cu",
                "replaces": ("centerpose_tpu/ops/dcn_pallas.py:1369,1182"
                             if wide else
                             "centerpose_tpu/ops/dcn_pallas.py:980"),
                "launches": 0,
                "max_abs_err": max(errs[k][0] for k in GRAD_NAMES),
                "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bb,
                "bound_by": bby, "library_ms": None}
            del x, off, mask, w, bias, ct
    say(f"  K2 bfloat16 per batch-{TRAIN_BATCH} step (16 calls, sum of the "
        f"site times): {k2_step:.4f} ms")
    return entries


def determinism_check():
    """Two calls on the same inputs give the same bits: the backward's
    gradients at every site shape, batch 8, in bfloat16 and float32; K1's
    y and om and K2's y at every site shape, batch 1 and 8, in bfloat16
    (split plans among them)."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc

    bf16 = torch.bfloat16
    for i, (cin, cout, hw, _) in enumerate(SITES):
        r = dc.site_max_dy(hw, hw, cin, cout, "pallas_full")
        for b in (1, TRAIN_BATCH):
            args = on_card(k1_inputs(700 + i, b, hw, cin, cout), bf16)
            y1, om1 = dc.launch_fused_forward(*args, r)
            y2, om2 = dc.launch_fused_forward(*args, r)
            x, off, mask, w, bias, _ = [
                t.to("cuda", bf16 if j != 4 else torch.float32).contiguous()
                for j, t in enumerate(k2_inputs(800 + i, b, hw, cin, cout,
                                                r))]
            z1 = dc.dcn_v2(x, off, mask, w, bias, r)
            z2 = dc.dcn_v2(x, off, mask, w, bias, r)
            torch.cuda.synchronize()
            same = {"K1 y": bool(torch.equal(y1, y2)),
                    "K1 om": bool(torch.equal(om1, om2)),
                    "K2 y": bool(torch.equal(z1, z2))}
            split = dc.forward_plan(bf16, b, hw, hw, cin, cout)["split"]
            say(f"  determinism {cin}->{cout} @{hw}x{hw} bfloat16 batch {b}"
                f" (split {split}): bit-equal "
                + " ".join(f"{n}={v}" for n, v in same.items()))
            check(all(same.values()), f"forward not deterministic at "
                  f"{cin}->{cout} @{hw} batch {b}: {same}")
            del args, y1, y2, om1, om2, x, off, mask, w, bias, z1, z2

    for i, (cin, cout, hw, _) in enumerate(SITES):
        r = dc.train_site_max_dy(hw, hw, cin, cout, "pallas_full")
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            x, off, mask, w, _, ct = [
                t.to("cuda", dt).contiguous()
                for t in k2_inputs(500 + i, TRAIN_BATCH, hw, cin, cout, r)]
            first = dc.dcn_v2_backward(x, off, mask, w, ct, r)
            second = dc.dcn_v2_backward(x, off, mask, w, ct, r)
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
            say(f"  determinism {cin}->{cout} @{hw}x{hw} {dtype} batch "
                f"{TRAIN_BATCH}: bit-equal "
                + " ".join(f"{n}={v}" for n, v in zip(GRAD_NAMES, same)))
            check(all(same), f"backward not deterministic at {cin}->{cout} "
                  f"@{hw} {dtype}: {dict(zip(GRAD_NAMES, same))}")
            del x, off, mask, w, ct, first, second


def edge_check():
    """At a 384x384 site where the reference's backward falls back to the
    VJP of jnp.clip, offsets placed exactly on +-R get gradient 0.5: the
    kernel with that edge against the plain version (TOL_BWD), and against
    itself with edge 1 (the dy gradient halved exactly there, every other
    value bit-equal)."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2_backward_plain

    site = None
    for cin, cout, stride in ((512, 256, 32), (256, 256, 16), (256, 128, 16),
                              (128, 128, 8), (128, 64, 8), (256, 64, 16),
                              (64, 64, 4)):
        hw = 384 // stride
        r = dc.train_site_max_dy(hw, hw, cin, cout, "pallas_full")
        edge = dc.train_site_edge_grad(hw, hw, cin, cout, "pallas_full")
        if r is not None and edge == 0.5:
            site = (cin, cout, hw, r)
    check(site is not None, "no 384x384 site takes the clip fallback")
    cin, cout, hw, r = site
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x, off, mask, w, _, ct = [
            t.to("cuda", dt).contiguous()
            for t in k2_inputs(600, 2, hw, cin, cout, r)]
        dy = off[..., 0::2]
        on_edge = torch.rand(dy.shape, device="cuda") < 0.1
        dy[on_edge] = torch.where(dy[on_edge] < 0, -float(r), float(r)).to(dt)
        n_edge = int((off[..., 0::2].float().abs() == r).sum().item())
        half = dc.dcn_v2_backward(x, off, mask, w, ct, r, 0.5)
        full = dc.dcn_v2_backward(x, off, mask, w, ct, r, 1.0)
        ref = dcn_v2_backward_plain(x, off, mask, w, ct, r, 0.5)
        torch.cuda.synchronize()
        rels = {n: ((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-12)).item()
                for n, a, b in zip(GRAD_NAMES, half, ref)}
        edge_pos = torch.zeros_like(off, dtype=torch.bool)
        edge_pos[..., 0::2] = off[..., 0::2].float().abs() == r
        halved = bool(torch.equal(half[1].float()[edge_pos],
                                  0.5 * full[1].float()[edge_pos]))
        others = bool(torch.equal(half[1][~edge_pos], full[1][~edge_pos])) \
            and all(bool(torch.equal(a, b)) for j, (a, b)
                    in enumerate(zip(half, full)) if j != 1)
        say(f"  edge {cin}->{cout} @{hw}x{hw} R={r} {dtype}: {n_edge} taps "
            f"on +-R; kernel(edge 0.5) vs plain max rel "
            + " ".join(f"{k} {v:.1e}" for k, v in rels.items())
            + f"; dy gradient halved there {halved}, the rest bit-equal "
            f"{others}")
        check(n_edge > 0, "no offset on the edge")
        for n, v in rels.items():
            check(v <= TOL_BWD[dtype], f"edge {n} {dtype}: rel err {v:.3e}")
        check(halved and others, f"edge gradient {dtype}: halved {halved}, "
              f"rest equal {others}")


def train_cfg(dtype: str = "bfloat16"):
    """The flagship config computing in ``dtype``."""
    from centerpose_tpu_torch.config import update_config

    return update_config(flagship_cfg(), {"model": {"compute_dtype": dtype}})


def train_batch(cfg, seed: int, n: int):
    """``n`` examples encoded by the port (train augmentation on) from
    synthetic 480x640 frames with 1-4 persons each, stacked."""
    import numpy as np

    from centerpose_tpu_torch.data.encode import encode_example, stack_batch
    from centerpose_tpu_torch.data.synthetic import make_person

    g = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        img = scene(int(g.integers(1 << 30)))
        anns = [make_person(g, 640, 480)[0]
                for _ in range(int(g.integers(1, 5)))]
        examples.append(encode_example(img, anns, cfg, g, is_train=True))
    return stack_batch(examples)


def _train_step_pair(cfg, state_dict, batch):
    """One training step (backward only) on the kernel path and on the
    plain path (``ops/dcn.dcn_v2`` at every site) from the same weights:
    [(loss, gradients, BatchNorm statistics, launch counts)] of each."""
    import torch

    from centerpose_tpu_torch.models import dla
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2 as dcn_v2_plain
    from centerpose_tpu_torch.train.trainer import Trainer

    results = []
    for plain in (False, True):
        trainer = Trainer(cfg, state_dict, device="cuda")
        dc.reset_launch_counts()
        if plain:
            dla.dcn_v2 = dcn_v2_plain
        try:
            stats = trainer.backward(batch)
            torch.cuda.synchronize()
        finally:
            dla.dcn_v2 = dc.dcn_v2
        counts = (dc.dcn_v2.launches, dc.dcn_v2_backward.launches,
                  dict(dc.dcn_v2.launches_by_site),
                  dict(dc.dcn_v2_backward.launches_by_site))
        grads = {n: (p.grad.detach().clone() if p.grad is not None else None)
                 for n, p in trainer.model.named_parameters()}
        bstats = {n: t.detach().clone()
                  for n, t in trainer.model.state_dict().items()
                  if n.endswith(("running_mean", "running_var"))}
        results.append((float(stats["loss"]), grads, bstats, counts))
        del trainer
    return results


def _step_gaps(a, b):
    """(loss rel err, BatchNorm statistics max rel err, gradient rows
    [(L2 rel, max rel, name)] worst first, the relative L2 of all the
    gradients together) of step ``a`` against ``b``; the DCN biases, which
    feed BatchNorm on batch statistics (zero up to rounding), are left
    out."""
    import torch

    (loss_a, g_a, s_a), (loss_b, g_b, s_b) = a[:3], b[:3]
    rows, diff2, norm2 = [], 0.0, 0.0
    for name, gb in g_b.items():
        ga = g_a[name]
        check((ga is None) == (gb is None), f"gradient presence of {name}")
        if gb is None:
            continue
        check(bool(torch.isfinite(ga).all()), f"gradient of {name} finite")
        if name.endswith("DCN_0.bias"):
            continue
        ga, gb = ga.float().cpu(), gb.float().cpu()
        diff2 += float((ga - gb).double().square().sum())
        norm2 += float(gb.double().square().sum())
        l2 = ((ga - gb).norm() / gb.norm().clamp_min(1e-30)).item()
        mx = ((ga - gb).abs().max() / gb.abs().max().clamp_min(1e-30)).item()
        rows.append((l2, mx, name))
    rows.sort(reverse=True)
    stat = max(((s_a[n].cpu() - s_b[n].cpu()).abs().max()
                / s_b[n].cpu().abs().max().clamp_min(1e-30)).item()
               for n in s_b)
    return (abs(loss_a - loss_b) / abs(loss_b), stat, rows,
            (diff2 / max(norm2, 1e-300)) ** 0.5)


def _tf32_probe():
    """Wrap ``models/common.tf32_convs``, which the repaired conv ->
    BatchNorm hand-off (``_ConvF32``) enters in its forward and in its
    backward; returns (records [(backward?, x dtype, TF32 on inside)],
    undo)."""
    import contextlib

    import torch

    from centerpose_tpu_torch.models import common

    seen, in_backward = [], [False]
    orig, orig_backward = common.tf32_convs, common._ConvF32.backward

    @contextlib.contextmanager
    def spy(x):
        with orig(x):
            seen.append((in_backward[0], x.dtype,
                         torch.backends.cudnn.allow_tf32))
            yield

    def backward(ctx, gy):
        in_backward[0] = True
        try:
            return orig_backward(ctx, gy)
        finally:
            in_backward[0] = False

    common.tf32_convs = spy
    common._ConvF32.backward = staticmethod(backward)

    def undo():
        common.tf32_convs = orig
        common._ConvF32.backward = staticmethod(orig_backward)
    return seen, undo


def train_model_check(state_dict):
    """One training step at 512x512, batch 2, kernel path against plain
    path, in float32 (loss, gradients, BatchNorm statistics, launch
    counts) and in bfloat16 (the same at TOL_TRAIN_BF16, with the TF32
    probe of the conv -> BatchNorm hand-off's backward)."""
    import numpy as np
    import torch

    cfg = train_cfg("float32")
    batch = train_batch(cfg, 5, 2)
    (loss_k, g_k, s_k, c_k), plain = _train_step_pair(cfg, state_dict, batch)
    want = {(cin, cout, hw, hw): n for cin, cout, hw, n in SITES}
    check(c_k[0] == 16 and c_k[1] == 16 and c_k[2] == want and c_k[3] == want,
          f"training step launches: K2 {c_k[0]}, backward {c_k[1]}, by site "
          f"{c_k[2]} / {c_k[3]}")
    loss_rel, stat_err, grad_rows, _ = _step_gaps((loss_k, g_k, s_k), plain)
    loss_p = plain[0]
    n_max_over = sum(1 for _, mx, _ in grad_rows if mx > 1e-4)
    say(f"  train step float32 512x512 batch 2: loss kernel {loss_k:.6f} "
        f"plain {loss_p:.6f} (rel {loss_rel:.2e}); BatchNorm statistics max "
        f"rel err {stat_err:.2e}; gradients of {len(grad_rows)} tensors: "
        f"worst L2 rel err {grad_rows[0][0]:.2e} ({grad_rows[0][2]}), worst "
        f"max rel err {max(r[1] for r in grad_rows):.2e}, {n_max_over} "
        f"tensors above 1e-4 max rel, median L2 rel err "
        f"{float(np.median([r[0] for r in grad_rows])):.2e}; K2 launches "
        f"{c_k[0]}, backward launches {c_k[1]} per step")
    check(loss_rel <= TOL_TRAIN_LOSS, f"train loss rel err {loss_rel:.3e}")
    check(stat_err <= TOL_TRAIN_STATS, f"BatchNorm stats rel err {stat_err}")
    check(grad_rows[0][0] <= TOL_TRAIN_GRAD_L2,
          f"gradient L2 rel err {grad_rows[0]}")

    cfg = train_cfg("bfloat16")
    seen, undo = _tf32_probe()
    try:
        kernel, plain = _train_step_pair(cfg, state_dict, batch)
    finally:
        undo()
    check(kernel[3][0] == 16 and kernel[3][1] == 16,
          f"bf16 training step launches: K2 {kernel[3][0]}, backward "
          f"{kernel[3][1]}")
    loss_rel, stat_err, grad_rows, total = _step_gaps(kernel, plain)
    median = float(np.median([r[0] for r in grad_rows]))
    fwd = [r for r in seen if not r[0]]
    bwd = [r for r in seen if r[0]]
    say(f"  train step bfloat16 512x512 batch 2: loss kernel {kernel[0]:.6f} "
        f"plain {plain[0]:.6f} (rel {loss_rel:.2e}, tolerance "
        f"{TOL_TRAIN_BF16['loss']:.0e}); BatchNorm statistics max rel err "
        f"{stat_err:.2e} ({TOL_TRAIN_BF16['stats']:.0e}); gradients: L2 rel "
        f"err of all {total:.2e}, median of the tensors' {median:.2e} (each "
        f"{TOL_TRAIN_BF16['grad_l2']:.0e}), worst tensor {grad_rows[0][0]:.2e} "
        f"({grad_rows[0][2]}); conv -> "
        f"BatchNorm hand-offs: {len(fwd)} forward and {len(bwd)} backward "
        f"entries over the two steps, backward on bf16 values with TF32 on "
        f"in {sum(1 for r in bwd if r[1] == torch.bfloat16 and r[2])}")
    check(loss_rel <= TOL_TRAIN_BF16["loss"],
          f"bf16 train loss rel err {loss_rel:.3e}")
    check(stat_err <= TOL_TRAIN_BF16["stats"],
          f"bf16 BatchNorm stats rel err {stat_err:.3e}")
    check(total <= TOL_TRAIN_BF16["grad_l2"]
          and median <= TOL_TRAIN_BF16["grad_l2"],
          f"bf16 gradient L2 rel err: all {total:.3e}, median {median:.3e}")
    # the hand-offs whose output no loss term reads (the project convs of
    # the level 3 and 4 trees, kept for their BatchNorm statistics) have
    # no backward
    check(len(fwd) - 4 <= len(bwd) <= len(fwd)
          and all(r[1] == torch.bfloat16 and r[2] for r in bwd),
          f"conv -> BatchNorm backward: {len(bwd)} of {len(fwd)} entered, "
          "each must read bf16 values with TF32 on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 left on")


def training(state_dict):
    """The training main path: the Trainer at batch 8, bfloat16,
    pallas_full, compact wire, from the snapshot.  Returns the launch
    counts by (kernel, site) of this run and the trainer and a batch for
    the trace."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.train.trainer import Trainer

    cfg = train_cfg()
    n_timed, n_fit = 6, 10
    t0 = time.perf_counter()
    batches = [train_batch(cfg, 100 + i, TRAIN_BATCH)
               for i in range(1 + n_timed)]
    encode_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    check(batches[0]["input"].dtype == np.uint8
          and batches[0]["input"].shape == (TRAIN_BATCH, 512, 512, 3)
          and batches[0]["hm"].dtype == np.float16, "compact-wire batch")
    trainer = Trainer(cfg, state_dict, device="cuda")
    dc.reset_launch_counts()
    first = trainer.train_step(batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step(b)["loss"] for b in batches[1:]]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    losses = [float(first["loss"])] + [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"training losses {losses}")
    fixed = batches[1]
    fit = [float(trainer.train_step(fixed)["loss"]) for _ in range(n_fit)]
    torch.cuda.synchronize()
    steps = 1 + n_timed + n_fit
    launches = {"dcn_v2": dict(dc.dcn_v2.launches_by_site),
                "dcn_v2_backward": dict(dc.dcn_v2_backward.launches_by_site)}
    check(dc.dcn_v2.launches == 16 * steps
          and dc.dcn_v2_backward.launches == 16 * steps
          and dc.dcn_v2_fused.launches == 0,
          f"training launches for {steps} steps: K2 {dc.dcn_v2.launches}, "
          f"backward {dc.dcn_v2_backward.launches}, K1 "
          f"{dc.dcn_v2_fused.launches}")
    check(trainer.optimizer.updates == steps, "one update per step")
    say(f"  train batch {TRAIN_BATCH} bf16: {step_ms:.2f} ms per step "
        f"({TRAIN_BATCH * 1e3 / step_ms:.2f} images/s, host clock, "
        f"synchronised, {n_timed} steps on fresh batches); host encode "
        f"{encode_ms:.1f} ms per batch of {TRAIN_BATCH} (before the steps, "
        "not in the step time); losses "
        + " ".join(f"{v:.3f}" for v in losses))
    say(f"  overfit {n_fit} steps on one batch: loss {fit[0]:.4f} -> "
        f"{fit[-1]:.4f} (" + " ".join(f"{v:.3f}" for v in fit) + ")")
    check(fit[-1] < fit[0], f"loss did not fall on a fixed batch: {fit}")
    return launches, trainer, fixed


def train_trace(trainer, batch):
    """One traced training step at batch 8: device busy and idle, K2's and
    the backward's shares, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    check(bool(rows), "training trace: the profiler recorded no device time")
    busy = sum(r[0] for r in rows)
    k2 = sum(r[0] for r in rows if "dcn_gemm" in r[2])
    bwd = sum(r[0] for r in rows if "dcn_bwd" in r[2])
    say(f"  train trace batch {TRAIN_BATCH}: device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms wall (idle {1 - busy / wall_ms:.1%}); K2 "
        f"{k2:.3f} ms ({k2 / busy:.1%} of busy), backward kernel {bwd:.3f} "
        f"ms ({bwd / busy:.1%})")
    for ms, count, key in rows[:15]:
        say(f"    {ms:9.3f} ms {count:4d}x {key[:90]}")



def eval_anchors() -> dict:
    """The reference's hard-benchmark AP of each evaluated mode, on the
    committed snapshot: single scale is ``cross_impl.pallas_full_bf16``
    (the flagship config); ``modes.ms_flip_nms`` adds flip and scales
    0.75, 1.0, 1.25."""
    ref = json.loads(ANCHORS.read_text())["flagship"]
    check(ref["cross_impl"]["pallas_full_bf16"]["model_path"].endswith(
        "params_f16.npz") and ref["modes"]["ms_flip_nms"][
        "model_path"].endswith("params_f16.npz"), "anchors not on the npz")
    check(ref["cross_impl"]["xla_bf16"]["model_path"].endswith(
        "params_f16.npz"), "xla_bf16 anchor not on the npz")
    return {"single": ref["cross_impl"]["pallas_full_bf16"]["stats"]["AP"],
            "ms_flip_nms": ref["modes"]["ms_flip_nms"]["stats"]["AP"],
            "xla_bf16": ref["cross_impl"]["xla_bf16"]["stats"]["AP"]}


def evaluation(state_dict, card: str):
    """The evaluation main path: the hard benchmark's 512 scenes drawn by
    the port's renderer, the bf16 pallas_full Detector (K1) over them at
    single scale and with flip and 3 scales (soft-NMS merge), OKS AP by the
    port's evaluator against the reference's; K1 must launch at every site
    in each mode."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.config import flagship_config
    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools.evaluate import STAGES, evaluate
    from centerpose_tpu_torch.tools.hard_eval import (CROSS_IMPL,
                                                      FLAGSHIP_MODES,
                                                      hard_dataset)

    want = eval_anchors()
    t0 = time.perf_counter()
    ds = hard_dataset(EVAL_N, EVAL_RENDER_WORKERS)
    t_render = time.perf_counter() - t0
    n_gt = len(ds.gt_annotations())
    say(f"  rendered {EVAL_N} hard scenes (seed 3, {n_gt} persons) in "
        f"{t_render:.2f} s ({EVAL_RENDER_WORKERS} processes)")
    modes = {"single": CROSS_IMPL["pallas_full_bf16"],
             "ms_flip_nms": FLAGSHIP_MODES["ms_flip_nms"],
             "xla_bf16": CROSS_IMPL["xla_bf16"]}
    for mode, opts in modes.items():
        cfg = flagship_config(opts)
        impl = "xla" if mode == "xla_bf16" else "pallas_full"
        check(cfg.model.dcn_impl == impl
              and cfg.model.compute_dtype == "bfloat16", f"{mode} config")
        det = Detector(cfg, state_dict, device="cuda")
        det.run(ds.get_raw(0)[0])  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        dc.reset_launch_counts()
        results, times, wall = evaluate(det, ds)
        # pallas_full: K1 at every site; xla: the om conv, then K2
        kernel, other = ((dc.dcn_v2, dc.dcn_v2_fused) if impl == "xla"
                         else (dc.dcn_v2_fused, dc.dcn_v2))
        per_call = (1 if impl == "xla"
                    else dc.KERNELS_PER_CALL[torch.bfloat16])
        sites = dict(kernel.launches_by_site)
        total = kernel.launches
        forwards = EVAL_N * len(cfg.test.test_scales)
        check(total == 16 * per_call * forwards and other.launches == 0,
              f"{mode}: launches {total} for {forwards} forwards "
              f"(other forward kernel {other.launches})")
        check(len(sites) == len(SITES),
              f"{mode}: launched at {len(sites)} sites")
        for img_id, res in results.items():
            rows = res[1]
            check(rows.ndim == 2 and rows.shape[1] == 39
                  and 0 < rows.shape[0] <= cfg.test.topk
                  and np.isfinite(rows).all(), f"{mode}: image {img_id} "
                  f"results {rows.shape}")
        t1 = time.perf_counter()
        stats = ds.run_eval(results, img_ids=list(results))
        t_eval = time.perf_counter() - t1
        ms = " ".join(f"{k} {1e3 * times[k] / EVAL_N:.2f}" for k in STAGES)
        say(f"  eval {mode}: AP {stats['AP']:.4f} AP50 {stats['AP50']:.4f} "
            f"AP75 {stats['AP75']:.4f} AR {stats['AR']:.4f} (reference "
            f"{want[mode]:.4f}, diff {stats['AP'] - want[mode]:+.4f}); "
            f"{EVAL_N / wall:.2f} images/s (host clock, Detector.run, "
            f"synchronised; ms per image: {ms}); OKS eval {t_eval:.2f} s; "
            f"{'K2' if impl == 'xla' else 'K1'} launches {total}; {card}")
        say(f"  eval {mode} stats: " + json.dumps(
            {k: round(float(v), 6) for k, v in stats.items()}))
        if mode in GATED_MODES:
            check(abs(stats["AP"] - want[mode]) <= TOL_AP,
                  f"{mode}: AP {stats['AP']:.4f} is not within {TOL_AP} of "
                  f"the reference's {want[mode]:.4f}")
        del det
    return ds


def backbone_anchors() -> dict:
    """The reference's single-scale f32 AP of each snapshot backbone on the
    hard benchmark (``output/hard_eval.json``: ``backbones``)."""
    from centerpose_tpu_torch.tools.hard_eval import BACKBONE_OPTS

    ref = json.loads(ANCHORS.read_text())["backbones"]
    for name, art in BACKBONES.items():
        check(ref[name]["model_path"]
              == f"output/{art}_hard_artifact/params_f16.npz"
              and ref[name]["cmd_opts"] == BACKBONE_OPTS
              and ref[name]["n_images"] == EVAL_N,
              f"{name}: the reference's row is not the snapshot's")
    return {name: ref[name]["stats"]["AP"] for name in BACKBONES}


def backbones(ds, card: str) -> None:
    """The other backbones, a main path: each committed snapshot through
    the port's ``tools/hard_eval`` backbone config (the defaults with
    ``model.name``: float32, single scale) and ``Detector.run`` over the
    evaluation phase's 512 scenes; OKS AP gated against the reference's
    row.  Their path holds no hand-written kernel: no DCN kernel may
    launch.  res_18 also serves ``run_batch`` at batch 8 (float32 and
    bfloat16), the bfloat16 one held against the float32 one."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools.evaluate import (STAGES, evaluate,
                                                     load_detector)
    from centerpose_tpu_torch.tools.hard_eval import backbone_config

    want = backbone_anchors()
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    for name, art in BACKBONES.items():
        path = f"output/{art}_hard_artifact/params_f16.npz"
        cfg = backbone_config(name, str(ROOT / path))
        check(cfg.model.compute_dtype == "float32"
              and tuple(cfg.test.test_scales) == (1.0,)
              and not cfg.test.flip_test, f"{name} config")
        det = load_detector(cfg, "cuda")
        det.run(ds.get_raw(0)[0])  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        dc.reset_launch_counts()
        results, times, wall = evaluate(det, ds)
        launched = sum(fn.launches for fn in dc.COUNTED)
        check(launched == 0, f"{name}: {launched} DCN kernel launches")
        for img_id, res in results.items():
            rows = res[1]
            check(rows.ndim == 2 and rows.shape[1] == 39
                  and 0 < rows.shape[0] <= cfg.test.topk
                  and np.isfinite(rows).all(),
                  f"{name}: image {img_id} results {rows.shape}")
        stats = ds.run_eval(results, img_ids=list(results))
        ms = " ".join(f"{k} {1e3 * times[k] / EVAL_N:.2f}" for k in STAGES)
        say(f"  backbone {name}: AP {stats['AP']:.4f} AP50 "
            f"{stats['AP50']:.4f} AP75 {stats['AP75']:.4f} AR "
            f"{stats['AR']:.4f} (reference {want[name]:.4f}, diff "
            f"{stats['AP'] - want[name]:+.4f}); {EVAL_N / wall:.2f} images/s "
            f"(host clock, Detector.run, float32, synchronised; ms per "
            f"image: {ms}); {card}")
        say(f"  backbone {name} stats: " + json.dumps(
            {k: round(float(v), 6) for k, v in stats.items()}))
        check(abs(stats["AP"] - want[name]) <= TOL_AP,
              f"{name}: AP {stats['AP']:.4f} is not within {TOL_AP} of the "
              f"reference's {want[name]:.4f}")
        if name == "res_18":
            frames = [ds.get_raw(i)[0] for i in range(BACKBONE_BATCH)]
            batch = torch.cat([det.pre_process(f)[0] for f in frames])
            batch = batch.cpu().numpy()
            dets_by, heads_by = {}, {}
            for dtype in ("float32", "bfloat16"):
                bdet = load_detector(update_config(
                    cfg, {"model.compute_dtype": dtype}), "cuda")
                dets = bdet.run_batch(batch)  # warm-up
                x = torch.from_numpy(batch).to("cuda")
                if x.dtype == torch.uint8:
                    x = (x.float() / 255.0 - bdet.mean) / bdet.std
                with torch.inference_mode():
                    heads_by[dtype] = {k: v.float()
                                       for k, v in bdet.model(x).items()}
                torch.cuda.synchronize()
                n_iter = 5
                t0 = time.perf_counter()
                for _ in range(n_iter):
                    dets = bdet.run_batch(batch)
                dt = time.perf_counter() - t0
                check(dets.shape == (BACKBONE_BATCH, 100, 40)
                      and np.isfinite(dets).all(),
                      f"res_18 run_batch {dtype}: {dets.shape}")
                say(f"  run_batch res_18 batch {BACKBONE_BATCH} {dtype}: "
                    f"{BACKBONE_BATCH * n_iter / dt:.2f} images/s "
                    f"({dt / n_iter * 1e3:.2f} ms per batch, host clock, "
                    f"synchronised); {card}")
                dets_by[dtype] = dets
                del bdet
            width = batch.shape[2] // 4
            f32, b16 = heads_by["float32"], heads_by["bfloat16"]
            errs = {k: ((b16[k] - f32[k]).abs().max()
                        / f32[k].abs().max()).item() for k in f32}
            n_conf, unmatched, worst = match_confident(
                *det_cells(dets_by["bfloat16"], width),
                *det_cells(dets_by["float32"], width), width)
            say("  run_batch res_18 bfloat16 vs float32: head rel err "
                + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                + f" (tolerance {TOL_BB_BF16:.0e}); {n_conf} centers score "
                f">= {CONFIDENT}, {unmatched} unmatched, worst score diff "
                f"{worst:.4f}")
            check(max(errs.values()) <= TOL_BB_BF16,
                  f"res_18 bfloat16 heads: rel err {errs}")
            check(n_conf >= 1 and unmatched == 0,
                  f"res_18 bfloat16 run_batch: {unmatched} of {n_conf} "
                  "confident centers unmatched in the float32 one")
        del det


def backbone_train_cfg(name: str, *opts):
    """The config ``tools/train.py --defaults model.name NAME`` builds
    (the defaults: float32, ``head_conv`` 64), compact wire, with
    ``opts``."""
    from centerpose_tpu_torch.tools.evaluate import run_config

    return run_config(None, ["model.name", name, "train.wire", "compact",
                             *opts], defaults=True)


def backbone_training(card: str) -> None:
    """Training the other backbones, a main path: for each snapshot
    backbone, a device check (one float32 step at 128x128, batch 2, card
    against host CPU), then the Trainer at 512x512, batch 8, compact wire,
    float32 and bfloat16 (warm-up, 6 timed steps, 10 on a fixed batch
    whose loss must fall); no DCN kernel may launch."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.train.trainer import Trainer
    from centerpose_tpu_torch.weights import state_dict_from_npz

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    small = backbone_train_cfg("res_18", "model.input_res", "128",
                               "model.output_res", "32")
    small_batch = train_batch(small, 21, 2)
    cfg0 = backbone_train_cfg("res_18")
    check(cfg0.model.compute_dtype == "float32" and cfg0.model.head_conv == 64
          and cfg0.model.input_res == BB_TRAIN_RES
          and cfg0.train.wire == "compact", "backbone training config")
    t0 = time.perf_counter()
    batches = [train_batch(cfg0, 300 + i, TRAIN_BATCH)
               for i in range(1 + BB_TRAIN_STEPS)]
    encode_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    check(batches[0]["input"].dtype == np.uint8
          and batches[0]["input"].shape == (TRAIN_BATCH, BB_TRAIN_RES,
                                            BB_TRAIN_RES, 3),
          "compact-wire batch")
    for name, art in BACKBONES.items():
        sd = state_dict_from_npz(
            str(ROOT / "output" / f"{art}_hard_artifact" / "params_f16.npz"))
        cfg = backbone_train_cfg(name, "model.input_res", "128",
                                 "model.output_res", "32")
        steps = []
        for device in ("cuda", "cpu"):
            trainer = Trainer(cfg, sd, device=device)
            stats = trainer.backward(small_batch)
            grads = {n: (p.grad.detach().float().cpu().clone()
                         if p.grad is not None else None)
                     for n, p in trainer.model.named_parameters()}
            check(trainer.optimizer.step(), f"{name}: no update")
            bstats = {n: t.detach().cpu().clone()
                      for n, t in trainer.model.state_dict().items()
                      if n.endswith(("running_mean", "running_var"))}
            steps.append((float(stats["loss"]), grads, bstats))
            del trainer
        loss_rel, stat_err, rows, total = _step_gaps(*steps)
        median = float(np.median([r[0] for r in rows]))
        say(f"  backbone {name} train step float32 128x128 batch 2, card "
            f"against host CPU: loss {steps[0][0]:.6f} / {steps[1][0]:.6f} "
            f"(rel {loss_rel:.2e}); BatchNorm statistics max rel err "
            f"{stat_err:.2e}; gradients of {len(rows)} tensors: L2 rel err "
            f"of all {total:.2e}, median of the tensors' {median:.2e}, worst "
            f"tensor {rows[0][0]:.2e} ({rows[0][2]}) (tolerances "
            f"{TOL_BB_TRAIN})")
        check(loss_rel <= TOL_BB_TRAIN["loss"]
              and stat_err <= TOL_BB_TRAIN["stats"]
              and total <= TOL_BB_TRAIN["grad_l2"]
              and median <= TOL_BB_TRAIN["grad_l2"],
              f"{name}: card against host CPU: loss {loss_rel:.3e}, "
              f"statistics {stat_err:.3e}, gradients all {total:.3e}, "
              f"median {median:.3e}")

        for dtype in ("float32", "bfloat16"):
            cfg = update_config(backbone_train_cfg(name),
                                {"model.compute_dtype": dtype})
            trainer = Trainer(cfg, sd, device="cuda")
            dc.reset_launch_counts()
            first = float(trainer.train_step(batches[0])["loss"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [trainer.train_step(b)["loss"] for b in batches[1:]]
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / BB_TRAIN_STEPS
            losses = [first] + [float(v) for v in losses]
            fit = [float(trainer.train_step(batches[1])["loss"])
                   for _ in range(BB_FIT_STEPS)]
            torch.cuda.synchronize()
            launched = sum(fn.launches for fn in dc.COUNTED)
            n_steps = 1 + BB_TRAIN_STEPS + BB_FIT_STEPS
            say(f"  backbone {name} train batch {TRAIN_BATCH} "
                f"{BB_TRAIN_RES}x{BB_TRAIN_RES} {dtype}: {step_ms:.2f} ms per "
                f"step ({TRAIN_BATCH * 1e3 / step_ms:.2f} images/s, host "
                f"clock, synchronised, {BB_TRAIN_STEPS} steps on fresh "
                f"batches); losses " + " ".join(f"{v:.3f}" for v in losses)
                + f"; fixed batch {fit[0]:.4f} -> {fit[-1]:.4f}; DCN "
                f"launches {launched}; {card}")
            check(np.isfinite(losses + fit).all(), f"{name} {dtype} losses")
            check(fit[-1] < fit[0],
                  f"{name} {dtype}: loss did not fall on a fixed batch: {fit}")
            check(launched == 0, f"{name} {dtype}: {launched} DCN launches")
            check(trainer.optimizer.updates == n_steps, "one update a step")
            del trainer
        torch.cuda.empty_cache()
    say(f"  host encode {encode_ms:.1f} ms per batch of {TRAIN_BATCH} "
        "(before the steps, not in the step time)")


def _bit_equal(a, b) -> bool:
    """Nested states (dicts, lists, tensors, numbers) equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                                b.reshape(-1).contiguous().view(torch.uint8)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_bit_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_bit_equal(x, y) for x, y in zip(a, b)))
    return a == b


def native_check(ds, cfg) -> None:
    """The native library is built, and its encoder fills the same targets
    as the numpy path (within the reference's 1e-5) over 64 examples."""
    import os

    import numpy as np

    from centerpose_tpu_torch import native
    from centerpose_tpu_torch.data.encode import encode_example

    check(native.available(), "the native library did not build or load")
    worst = 0.0
    for i in range(NATIVE_EXAMPLES):
        img, anns = ds.get_raw(i % len(ds))
        outs = []
        for disable in (False, True):
            if disable:
                os.environ["CENTERPOSE_DISABLE_NATIVE"] = "1"
            try:
                outs.append(encode_example(img, anns, cfg,
                                           np.random.default_rng((7, i))))
            finally:
                os.environ.pop("CENTERPOSE_DISABLE_NATIVE", None)
        nat, ref = outs
        for key in ("hm", "hm_hp", "wh", "hps", "reg", "reg_mask", "hps_mask",
                    "hp_offset", "hp_mask"):
            a, b = nat[key].astype(np.float64), ref[key].astype(np.float64)
            err = float(np.abs(a - b).max())
            worst = max(worst, err)
            check(np.allclose(a, b, rtol=TOL_NATIVE, atol=TOL_NATIVE),
                  f"native encoder {key} (example {i}): max err {err:.3e}")
        for key in ("ind", "hp_ind"):
            check(np.array_equal(nat[key], ref[key]),
                  f"native encoder {key} (example {i})")
    say(f"  native library: encoder against the numpy path over "
        f"{NATIVE_EXAMPLES} examples, max abs err {worst:.3e} (limit "
        f"{TOL_NATIVE})")


def training_cli(card: str) -> None:
    """The training CLI main path: two runs of tools/train.py main() (the
    second a resume), with the files, launch counts, resume, loader and
    native checks."""
    import tempfile

    import numpy as np
    import torch

    from centerpose_tpu_torch.config import flagship_config
    from centerpose_tpu_torch.data.loader import DataLoader
    from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
    from centerpose_tpu_torch.eval.harness import BUCKET_CAP
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools import train as train_cli
    from centerpose_tpu_torch.train.checkpoints import to_host

    with tempfile.TemporaryDirectory(prefix="cp_train_cli_") as tmp:
        opts = ["train.batch_size", str(TRAIN_BATCH),
                "train.num_workers", str(CLI_WORKERS),
                "train.val_intervals", "1",
                "train.val_ap_limit", str(CLI_AP_LIMIT),
                "output_dir", tmp, "exp_id", "smoke"]
        argv = ["--synthetic", "--hard", "--synthetic-size",
                str(CLI_STEPS * TRAIN_BATCH), *opts]
        cfg = flagship_config(opts)
        check(cfg.model.name == "dla_34" and cfg.model.input_res == 512
              and cfg.model.compute_dtype == "bfloat16"
              and cfg.model.dcn_impl == "pallas_full", "training CLI config")
        dc.reset_launch_counts()
        t0 = time.perf_counter()
        run1 = train_cli.main(argv + ["train.epochs", str(CLI_EPOCHS)])
        torch.cuda.synchronize()
        t_run1 = time.perf_counter() - t0
        k1, k2, bwd = (dc.dcn_v2_fused.launches, dc.dcn_v2.launches,
                       dc.dcn_v2_backward.launches)
        live = run1["trainer"]
        log_dir = Path(run1["log_dir"])
        steps = CLI_EPOCHS * CLI_STEPS
        for e in run1["epochs"]:
            say(f"  train CLI epoch {e['epoch']}: {e['img_per_s']:.2f} "
                f"images/s, data_wait_frac {e['data_wait_frac']:.4f} "
                f"(data_wait_s {e['data_wait_s']:.3f}), loss "
                f"{e.get('loss', float('nan')):.4f}, val AP "
                f"{e.get('AP', float('nan')):.4f}; {card}")
        say(f"  train CLI run: {t_run1:.2f} s for {CLI_EPOCHS} epochs of "
            f"{CLI_STEPS} steps at batch {TRAIN_BATCH} ({CLI_WORKERS} encode "
            f"workers), validation and checkpoints included; launches K1 "
            f"{k1}, K2 {k2}, backward {bwd}")
        for name in ("log.txt", "scalars.jsonl", "model_last",
                     "model_last.meta.json", "model_best",
                     "model_best.meta.json"):
            check((log_dir / name).is_file(), f"training CLI wrote no {name}")
        scalars = [json.loads(line) for line in
                   (log_dir / "scalars.jsonl").read_text().splitlines()]
        losses = [r["value"] for r in scalars if r["tag"] == "train/loss"]
        check(len(losses) == CLI_EPOCHS and all(np.isfinite(losses)),
              f"logged train losses {losses}")
        check(live.step == steps and len(run1["epochs"]) == CLI_EPOCHS,
              f"training CLI ran {live.step} steps")
        check(k2 == 16 * steps and bwd == 16 * steps,
              f"training CLI: K2 {k2}, backward {bwd} for {steps} steps")
        ap_forwards = CLI_EPOCHS * -(-CLI_AP_LIMIT // BUCKET_CAP)
        check(k1 >= 16 * ap_forwards,
              f"training CLI: K1 {k1} below {16 * ap_forwards} for the AP "
              "passes")
        best_checkpoint(cfg, log_dir / "model_best")

        # resume: a third epoch from model_last
        dc.reset_launch_counts()
        run2 = train_cli.main(argv + ["train.epochs", str(CLI_EPOCHS + 1),
                                      "train.resume", "1"])
        check(run2["start_epoch"] == CLI_EPOCHS
              and [e["epoch"] for e in run2["epochs"]] == [CLI_EPOCHS + 1],
              f"resume started at epoch {run2['start_epoch'] + 1}")
        check("resumed from" in (log_dir / "log.txt").read_text(),
              "no resume line in log.txt")
        want = to_host(live.state())
        got = run2["restored"]
        for key in ("step", "model", "bn", "optimizer"):
            check(_bit_equal(got[key], want[key]),
                  f"resumed {key} differs from the live trainer's")
        lr = [g["lr"] for g in live.optimizer.opt.param_groups]
        check(got["optimizer"]["updates"] == live.optimizer.updates == steps
              and [g["lr"] for g in got["optimizer"]["opt"]["param_groups"]]
              == lr, "resumed schedule position")
        train_ds = SyntheticPoseDataset(CLI_STEPS * TRAIN_BATCH, seed=1,
                                        hard=True)
        first = next(DataLoader(train_ds, cfg, TRAIN_BATCH,
                                seed=cfg.train.seed).epoch(CLI_EPOCHS + 1))
        live_loss = float(live.train_step(first)["loss"])
        check(run2["first_loss"] == live_loss,
              f"resumed first loss {run2['first_loss']!r} against the live "
              f"trainer's {live_loss!r}")
        say(f"  resume: started at epoch {CLI_EPOCHS + 1}, state bit-equal "
            f"(step {got['step']}, {len(got['model'])} parameters, "
            f"{len(got['bn'])} buffers, Adam state of "
            f"{len(got['optimizer']['opt']['state'])} parameters, update "
            f"{got['optimizer']['updates']}, lr {lr[0]:.3e}); first loss "
            f"{live_loss!r} equal; K2 {dc.dcn_v2.launches} backward "
            f"{dc.dcn_v2_backward.launches} K1 {dc.dcn_v2_fused.launches}")
        del run1, run2, live

    # the loader: 8 workers against none, byte for byte
    loaders = [DataLoader(train_ds, cfg, TRAIN_BATCH, seed=cfg.train.seed,
                          num_workers=n) for n in (CLI_WORKERS, 0)]
    try:
        got = [[b for _, b in zip(range(3), ld.epoch(1))] for ld in loaders]
    finally:
        for ld in loaders:
            ld.close()
    for i, (a, b) in enumerate(zip(*got)):
        check(a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and a[k].tobytes() == b[k].tobytes() for k in a),
            f"loader batch {i}: {CLI_WORKERS} workers differ from 0")
    say(f"  loader: the first 3 batches of epoch 1 with {CLI_WORKERS} workers "
        "equal those with none, byte for byte")
    native_check(train_ds, cfg)
    torch.cuda.empty_cache()


def best_checkpoint(cfg, path: Path) -> None:
    """The training CLI's ``model_best`` through ``tools/evaluate.
    load_detector`` on the card: the weights it restores are the file's,
    bit for bit (the Detector holds them cast to the compute dtype,
    BatchNorm's statistics in float32), and ``Detector.run`` launches K1."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools.evaluate import (checkpoint_state_dict,
                                                     load_detector)
    from centerpose_tpu_torch.train.checkpoints import load_checkpoint

    cfg = update_config(cfg, {"test": {"model_path": str(path)}})
    payload = load_checkpoint(str(path))
    want = {**payload["model"], **{k: v for k, v in payload["bn"].items()
                                   if k.endswith(("running_mean",
                                                  "running_var"))}}
    sd = checkpoint_state_dict(cfg, str(path))
    check(all(_bit_equal(sd[k], v) for k, v in want.items()),
          "model_best: restored weights differ from the file's")
    det = load_detector(cfg, "cuda")
    live = {**dict(det.model.named_parameters()),
            **dict(det.model.named_buffers())}
    for k, v in want.items():
        t = live[k].detach()
        check(_bit_equal(t.cpu(), v.to(t.dtype)),
              f"model_best: the Detector's {k} differs from the file's")
    dc.reset_launch_counts()
    ret = det.run(scene(7))
    torch.cuda.synchronize()
    res = ret["results"][1]
    check(dc.dcn_v2_fused.launches == 16 * dc.KERNELS_PER_CALL[
        torch.bfloat16] and res.shape == (100, 39)
        and bool(np.isfinite(res).all()),
          f"model_best Detector.run: K1 launches {dc.dcn_v2_fused.launches}")
    say(f"  model_best via load_detector: {len(want)} tensors bit-equal to "
        f"the file's; Detector.run K1 launches {dc.dcn_v2_fused.launches}, "
        f"top score {res[0, 4]:.4f}")


def only_training(card: str) -> int:
    """``--only training``: the build, the training main path and its
    trace (no result line)."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    phase("build CUDA library", build)
    state_dict = state_dict_from_npz(str(NPZ))
    _, trainer, fixed = phase("training (main path)",
                              lambda: training(state_dict))
    phase("training trace", lambda: train_trace(trainer, fixed))
    say(card)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "centerpose_tpu_torch").is_dir() or not NPZ.exists():
        print("chip_smoke: run from the root of the centerpose repository "
              "(the port package or the dla_34 snapshot is missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_all = time.perf_counter()

    card = phase("card", card_line)
    say(f"  {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--only", "training"]:
        return only_training(card)
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    phase("build CUDA library", build)
    entries = phase("kernel check", kernel_check)
    train_entries = phase("training kernel check", train_kernel_check)
    phase("determinism check", determinism_check)
    phase("edge check", edge_check)

    from centerpose_tpu_torch.weights import state_dict_from_npz

    state_dict = phase("load dla_34 snapshot",
                       lambda: state_dict_from_npz(str(NPZ)))
    phase("model check", lambda: model_check(state_dict))
    phase("model check (conv ablation)", conv_ablation_check)
    phase("training model check", lambda: train_model_check(state_dict))
    launches, det, batch = phase("serving (main path)",
                                 lambda: serving(state_dict))
    phase("trace", lambda: trace(det, batch))
    del det
    demo_launches = phase("demo (main path)", lambda: demo(state_dict, card))
    train_launches, trainer, fixed = phase("training (main path)",
                                           lambda: training(state_dict))
    phase("training trace", lambda: train_trace(trainer, fixed))
    del trainer, fixed
    ds = phase("evaluation (main path)", lambda: evaluation(state_dict, card))
    phase("backbones (serving, main path)", lambda: backbones(ds, card))
    del ds
    phase("training CLI (main path)", lambda: training_cli(card))
    phase("backbones (training, main path)", lambda: backbone_training(card))
    for site, entry in entries.items():
        check(launches.get(site, 0) > 0 and demo_launches.get(site, 0) > 0,
              f"K1 never launched at site {site}")
        entry["launches"] = launches[site] + demo_launches[site]
    for (kernel, site), entry in train_entries.items():
        entry["launches"] = train_launches[kernel].get(site, 0)
        check(entry["launches"] > 0,
              f"{kernel} never launched at site {site}")
    kernels = list(entries.values()) + list(train_entries.values())
    say(f"[phase] total {time.perf_counter() - t_all:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
