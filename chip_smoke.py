#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
``nvcc``.  It drives ``centerpose_tpu_torch`` through its flagship paths,
dla_34 at 512x512 in bfloat16 with the committed dla_34 snapshot
(``output/dla34_hard_artifact/params_f16.npz``): serving and training.  It
prints one flushed line per phase with the seconds it took:

1. the card (``nvidia-smi``) and the build of the CUDA libraries (one
   ``nvcc`` per source, started together);
2. kernel check: K1 (``dcn_v2_fused``) against its plain version at the 7
   DCN site shapes of dla_34 @512, batch 1, in float32 (TF32 off) and
   bfloat16, and at batch 8 (the serving batch) in bfloat16, with offsets
   large enough to exercise the y-clamp; time per call beside the plain
   version's and the bound of the card;
3. training kernel check: K2 (``dcn_v2``) and the backward kernel
   (``dcn_v2_backward``: dx, doffset, dmask, dW, dbias) against their plain
   versions (``ops/dcn.dcn_v2`` and its autograd) on one cotangent, at the 7
   site shapes, in float32 at batch 1 and bfloat16 at batch 8 (the training
   batch), with offsets that clamp at some taps;
4. model check: the whole model's inference kernel path against its plain
   path on the card (head errors, overlap of the top-100 decoded centers),
   in float32 and bfloat16, and 16 K1 calls (32 kernel launches: the om
   conv and the product) per forward;
5. training model check: one training step at 512x512, batch 2, float32,
   from the snapshot, kernel path against plain path: the loss, every
   parameter's gradient and the BatchNorm statistics after the step; 16 K2
   and 16 backward launches per step;
6. serving, a main path: ``Detector.run`` on 4 images and
   ``Detector.run_batch`` at batch 8, with the launch counts of that run;
7. trace: one batch-8 ``run_batch`` under ``torch.profiler``, device time
   by kernel;
8. training, a main path: the port's ``Trainer`` at batch 8, bfloat16,
   ``pallas_full``, compact wire, on batches encoded by the port's
   ``encode_example`` (train augmentation on) from synthetic frames: one
   warm-up step, 6 timed steps on fresh batches, then 10 steps on one fixed
   batch whose loss must fall; the launch counts of that run;
9. training trace: one step under ``torch.profiler``.

Then it prints the kernels' JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
exit code is then not 0.  Without a CUDA device, or outside the
repository, it prints no result and exits with 1.  It writes nothing but
the kernel build directory (``centerpose_tpu_torch/build/``, git-ignored).
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
# order, and dx, dW and dbias summed with atomics in an order that varies
# from run to run.  bfloat16: both compute in f32 from the same bf16
# inputs and round each output to bf16 once (an ulp is 2^-8 of a value);
# the sampled columns that dW multiplies are rounded to bf16 too, and a
# one-ulp-of-f32 difference before that rounding may move one column
# element by a bf16 ulp.
TOL_K2 = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_NAMES = ("dx", "doffset", "dmask", "dW", "dbias")
# Training model check (float32, 512x512, batch 2, kernel vs plain path):
# the loss; each BatchNorm statistic; each parameter's gradient by its
# relative L2 error.  The two paths differ by the kernels' f32 summation
# order (dx and dW by atomics), which the BatchNorms and ReLUs between the
# 16 sites carry upstream: the worst tensor read 1.72e-4 on an H100 (median
# 2.69e-5).  A site whose backward is wrong by a percent or more moves that
# site's own tensors by as much, ten times the limit.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_STATS = 1e-4
TOL_TRAIN_GRAD_L2 = 1e-3
TRAIN_BATCH = 8  # bench.py's train_batch


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
                f"bound {bound_ms:.5f} ms ({bound_by})")
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
            f"plain {plain8:.4f} ms bound {bound8:.5f} ms ({by8})")
        check(rel8 <= TOL_K1["bfloat16"],
              f"K1 {cin}->{cout} @{hw} bfloat16 batch 8: rel err {rel8:.3e}")
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
    from centerpose_tpu_torch.config import default_config, update_config

    return update_config(default_config(), {
        "model": {"name": "dla_34", "input_res": 512, "output_res": 128,
                  "head_conv": 256, "dcn_impl": "pallas_full",
                  "dcn_max_dy": 0, "compute_dtype": "bfloat16"},
        "train": {"lr": 1.25e-4, "wire": "compact",
                  "batch_size": TRAIN_BATCH}})


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
        check(launches == 16 * dc.KERNELS_PER_CALL,
              f"K1 kernel launches per forward: {launches}")
        want = {(cin, cout, hw, hw): n * dc.KERNELS_PER_CALL
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
            f"{launches} ({launches // dc.KERNELS_PER_CALL} calls); "
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
    check(total == 16 * dc.KERNELS_PER_CALL * forwards,
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
    rs = [dc.train_site_max_dy(hw, hw, cin, cout, "pallas_full")
          for cin, cout, hw, _ in SITES]
    check(rs == [24, 12, 12, 12, 12, 12, 6], f"training site policy: {rs}")
    for i, ((cin, cout, hw, _), r) in enumerate(zip(SITES, rs)):
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
                           for k, (e, q) in errs.items()))
            for name, (_, rel) in errs.items():
                tol = (TOL_K2 if name == "y" else TOL_BWD)[dtype]
                check(rel <= tol, f"{name} {cin}->{cout} @{hw} {dtype}: rel "
                      f"err {rel:.3e} > {tol:.0e}")
            if b != TRAIN_BATCH:
                continue
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
    return entries


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


def train_model_check(state_dict):
    """One float32 training step at 512x512, batch 2, kernel path against
    plain path: loss, gradients, BatchNorm statistics, launch counts."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.models import dla
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2 as dcn_v2_plain
    from centerpose_tpu_torch.train.trainer import Trainer

    cfg = train_cfg("float32")
    batch = train_batch(cfg, 5, 2)
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
    (loss_k, g_k, s_k, c_k), (loss_p, g_p, s_p, _) = results
    want = {(cin, cout, hw, hw): n for cin, cout, hw, n in SITES}
    check(c_k[0] == 16 and c_k[1] == 16 and c_k[2] == want and c_k[3] == want,
          f"training step launches: K2 {c_k[0]}, backward {c_k[1]}, by site "
          f"{c_k[2]} / {c_k[3]}")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rows = []
    for name, gp in g_p.items():
        gk = g_k[name]
        check((gk is None) == (gp is None), f"gradient presence of {name}")
        if gp is None:
            continue
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} finite")
        if name.endswith("DCN_0.bias"):
            continue  # feeds BatchNorm on batch statistics: zero + rounding
        l2 = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
        mx = ((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)).item()
        grad_rows.append((l2, mx, name))
    grad_rows.sort(reverse=True)
    stat_err = max(((s_k[n] - s_p[n]).abs().max()
                    / s_p[n].abs().max().clamp_min(1e-30)).item() for n in s_p)
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
    phase("build CUDA library", build)
    entries = phase("kernel check", kernel_check)
    train_entries = phase("training kernel check", train_kernel_check)

    from centerpose_tpu_torch.weights import state_dict_from_npz

    state_dict = phase("load dla_34 snapshot",
                       lambda: state_dict_from_npz(str(NPZ)))
    phase("model check", lambda: model_check(state_dict))
    phase("training model check", lambda: train_model_check(state_dict))
    launches, det, batch = phase("serving (main path)",
                                 lambda: serving(state_dict))
    phase("trace", lambda: trace(det, batch))
    del det
    train_launches, trainer, fixed = phase("training (main path)",
                                           lambda: training(state_dict))
    phase("training trace", lambda: train_trace(trainer, fixed))
    for site, entry in entries.items():
        entry["launches"] = launches.get(site, 0)
        check(entry["launches"] > 0, f"K1 never launched at site {site}")
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
