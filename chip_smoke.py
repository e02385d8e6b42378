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
   DCN site shapes of dla_34 @512, batch 1 and 8 (the serving batch), in
   float32 (TF32 off) and bfloat16, with offsets large enough to exercise
   the y-clamp; time per call beside the plain version's, the bound of the
   card, the bytes the call gathers (mostly from L2) and the launch plan
   (kernel, tile, split, stages, launches); K1's time per forward (the 16
   calls) at batch 1 and 8 in each dtype;
3. training kernel check: K2 (``dcn_v2``) and the backward kernel
   (``dcn_v2_backward``: dx, doffset, dmask, dW, dbias) against their plain
   versions (``ops/dcn.dcn_v2`` and its autograd) on one cotangent, at the 7
   site shapes, in float32 and bfloat16 at batch 1 and 8 (the training
   batch), with offsets that clamp at some taps; K2's time per step (16
   calls) at batch 1 and 8 in each dtype;
   then a determinism check: at the 7 site shapes, batch 8, in bfloat16
   and float32, two backward calls on the same inputs give bit-equal dx,
   doffset, dmask, dW and dbias, and at batch 1 and 8 in bfloat16 and
   float32 two K1 calls bit-equal y and om, two K2 calls bit-equal y
   (split plans among them); and an edge check at a 384x384 site whose
   reference backward falls back to the VJP of ``jnp.clip`` (gradient 0.5
   where |dy| is exactly R): the kernel with that edge against the plain
   version, and against itself with edge 1;
4. model check: the whole model's inference kernel path against its plain
   path on the card (head errors, overlap of the top-100 decoded centers),
   in float32 and bfloat16, and 16 K1 calls per forward
   (``dcn_cuda.KERNELS_PER_CALL`` launches each: 16 kernel launches in
   either dtype, the om conv and the product in one); then the
   ``dcn_impl: conv`` ablation (dla_34 @512 bf16 from
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
7c. export, a main path: the flagship's serving function
   (``inference/detector.ServingNet``) at batch 8 from the snapshot,
   exported with ``torch.export`` (``tools/export.export_serving``) on 8
   pre-processed frames: 16 K1 operator nodes in the graph; saved to a
   temporary directory, reloaded through ``tools/export.load_serving``
   (which runs a bf16 program with TF32 on in cuDNN, as eager serving
   runs its convolutions) and run: 16 K1 launches, rows bit-equal to
   ``Detector.process`` on the same input; then compiled
   (``torch.compile``, fullgraph): 16 K1 launches, confident rows within
   DEMO_PX and DEMO_SCORE of eager's; the export, save, load and compile
   seconds, the artifact's MB, FLOPs per call, the peak temporary MB, ms
   per call compiled, reloaded and eager, and one traced call of each
   (device busy of wall); then two exports where DCN sites run K2 (the
   operator ``centerpose::dcn_v2``): ``pallas_full`` at 1024x1024, batch
   1 (11 K1 and 5 K2 calls), and ``xla`` at 512x512, batch 2 (16 K2
   calls, unclamped), each saved, reloaded and run: one operator node per
   eager call, K1 and K2 launches by site as eager's, rows bit-equal (not
   compiled);
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
   ``cross_impl.xla_bf16``, and the ``pallas_full`` float32 row at single
   scale (K1 in float32), printed beside the reference's
   ``cross_impl.pallas_full_f32`` and ``xla_f32``;
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

12b. data-parallel training, a main path (``parallel/mesh.py``): the DDP
   ``Trainer`` at world size 1 on NCCL, 2 steps at batch 8 from the
   snapshot, its parameters and BatchNorm buffers bit-equal to the plain
   Trainer's on the same batches (cuDNN deterministic in both), ms per
   step of each; two ranks on the one card over gloo (NCCL refuses two
   ranks on one device; gloo all-reduces CUDA tensors through the host,
   so their speed is shared-device, never scaling), 4 images each
   (``python3 chip_smoke.py --dp-rank R ...``, a rank's own run): one f32
   step (TF32 off) and one bf16 step against the one-process Trainer on
   the same 8 images (the global loss, every all-reduced gradient, the
   BatchNorm statistics; TOL_TRAIN_* and TOL_TRAIN_BF16), then 2 SGD
   steps after which the ranks' parameters are bit-identical, K2 and the
   backward launched 16 times per step on each rank; ``tools/train.py
   --multihost`` on the two ranks (1 epoch of 4 steps, validation and AP
   on 32 images on rank 0): rank 0's files alone, finite losses, K1 in
   the AP pass, global images/s and ``data_wait_frac`` (shared-device);
   ``tools/bench_scaling.py --nprocs 1`` with the card line;
14. bench suite: ``tools/bench_suite`` (dla_34 ``pallas_full/bfloat16``
   infer at batch 1 and 8 and train at batch 8; res_18 ``bfloat16`` infer
   at batch 1 and 8) and ``tools/bench_eval`` (the mobilenetv3 video row
   over 64 frames, the hrnet_w32 multi-scale flip row over 8 images,
   serial and pipelined); each row printed as JSON with the card.
15. spatial sharding, a main path (``parallel/spatial.py``): the serving
   forward with the image rows split over ranks, through ``Detector(mesh=
   create_mesh_2d(1, n))``: dla_34 bf16 ``pallas_full`` at 512x512 on
   1 x 2 and 1 x 4 meshes (K1 at every site on every rank, at the shard's
   halo'd rows), res_18 f32 and dla_34 f32 (TF32 off) on 1 x 2, dla_34
   bf16 at 1024x1024 on 1 x 2 and 1 x 4, and dla_34 bf16 where the rows
   split unevenly (480x480 on 1 x 2 and 1 x 4, 480x512 and a 1080p frame,
   1088x1920 under keep_res, on 1 x 4: K1 and K2 at each site as the whole
   image's policy sends it), batch 2 from the snapshots; the ranks
   (``python3 chip_smoke.py --sp-rank R ...``) share the one card
   over gloo (NCCL refuses two ranks on one device; the exchanges go
   through the host, so the times check the path, not scaling).  Each run
   prints the gathered heads' worst difference from the one-process
   forward beside three controls (the first call, the batch order
   swapped, each image alone), the decoded rows matched, ms per
   ``process()`` call sharded and in one process, each rank's peak MB
   (and the largest and smallest shard's) and each rank's kernel launches,
   held per site against one process's;
16. offsets, a main path: ``tools/offsets_hist`` (``--skip-ap``) on the
   snapshot over 8 synthetic val images: K1's own offsets at each of the
   16 DCN sites, every value finite, every fraction in [0, 1], K1
   launched at every site; it prints the worst share of taps past R;
17. ablation, a main path: ``tools/ablate_step`` at batch 8 (the serving
   forward with and without decode, the trunk, the ``conv`` forward, the
   forward with ``dcn_fused_om`` off, the training step and its ``conv``
   counterpart: wall and device-busy ms per call, every one finite and
   above 0; K1, K2 and backward launches per call as ABL_LAUNCHES) and
   ``tools/bench_input_pipeline`` on ABL_IMAGES images (render, encode,
   the loader over 0, 1 and all cores with either encoder, the prefetch
   of both wires, whose bytes per image must be their tensors'
   arithmetic, and the card's training rate); each printed as JSON with
   the card; the unfused-om forward's heads and decoded rows against the
   fused forward's on 8 frames.

``python3 chip_smoke.py --only training`` runs the build, the training
main path and its trace alone, ``--only serving`` the build and the
serving main path, ``--only data-parallel`` the build and the
data-parallel phase, ``--only spatial`` the build and the spatial phase,
``--only offsets`` the build and the offsets phase, ``--only ablation``
the build and the ablation phase, ``--only kernels`` the build, the
kernel, training kernel and determinism checks and the model check (to
compare two trees in one call).

Then it prints the kernels' JSON line (K1's ``launches``: the serving,
demo, export, spatial and offsets phases' together; K2's: the training
main path's, the two data-parallel ranks', the ``xla`` export's and the
ablation phase's; the backward's: the training main path's, the two
data-parallel ranks' and the ablation phase's), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failed
check raises, and the exit code is then not 0. Without a CUDA device, or
outside the repository, it prints no result and exits with 1. It writes
nothing but the kernel build directory (``centerpose_tpu_torch/build/``,
git-ignored) and the training CLI's logs and checkpoints (in a temporary
directory, removed at the end).
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
# The data-parallel phase (dla_34 @512 from the snapshot, global batch
# TRAIN_BATCH): the DDP Trainer at world size 1 on NCCL against the plain
# Trainer, bit for bit over DP_STEPS steps (cuDNN held to deterministic
# algorithms in both); two ranks on the one card over gloo (NCCL refuses
# two ranks on one device), each with half of the batch: one f32 and one
# bf16 step against the one-process Trainer on the same 8 images at the
# training model check's tolerances (the ranks' halves differ from the
# whole batch in the order of the sums, as the kernels' order does; where
# the one-process step fed the batch's halves swapped, a control of that
# order alone, lies further, at twice the control's distance: on an H100
# its worst f32 tensor read 8.95e-4 and its bf16 gradients 4.81e-2 over
# the model), then
# DP_STEPS SGD steps after which the ranks' parameters are bit-identical;
# the CLI on the two ranks, 1 epoch of DP_CLI_STEPS steps with validation
# and AP on CLI_AP_LIMIT images; bench_scaling at world size 1.  A rank
# that has not ended after DP_TIMEOUT seconds fails the phase.
DP_STEPS, DP_CLI_STEPS, DP_CLI_WORKERS, DP_TIMEOUT = 2, 4, 4, 600
DP_BENCH_ITERS = 5
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
# The export phase: the flagship's serving function exported at the serving
# batch; the reloaded program's rows bit-equal to Detector.process's (the
# same ops on the same input, the same TF32 scope), the compiled one's
# matched to them at the demo's limits (Inductor fuses the elementwise
# work around the convs and the decode).
EXPORT_BATCH = 8
# Exports wherever a DCN site runs K2 (the operator centerpose::dcn_v2),
# after the flagship's: (what, model overrides, size, batch, K1 calls, K2
# calls per forward).  At 1024x1024 the stride-4 sites (width 256) leave
# K1's envelope and run K2 unclamped; under xla every site runs K2
# unclamped.  Each reloaded program's rows bit-equal to eager's and its
# K1 and K2 launches by site equal to eager's; not compiled (Inductor
# takes 71-107 s per program).
EXPORT_K2_CASES = [("pallas_full 1024", {}, 1024, 1, 11, 5),
                   ("xla 512", {"dcn_impl": "xla"}, 512, 2, 0, 16)]
# The bench suite phase: timed calls per infer row (train rows take
# max(5, BENCH_ITERS // 2) steps), video frames, multi-scale flip images.
BENCH_ITERS, BENCH_FRAMES, BENCH_IMAGES = 10, 64, 8
# The spatial-sharding phase (parallel/spatial.py): the serving forward
# with the image rows split over ranks that share the one card over gloo
# (NCCL refuses two ranks on one device; gloo's all_reduce stages CUDA
# tensors through the host, so the times check the path and never show
# scaling).  Each case: (factory name, compute dtype, size, the spatial
# widths of its 1 x n meshes), batch SP_BATCH from the name's snapshot; a
# size n is fix_res at n x n on 640x480 frames, a size (h, w) keep_res
# (test.pad_bucket 32, upstream's padding) on w x h frames.  dla_34 runs
# under pallas_full, each site at the kernel and radius of the whole
# image's policy: K1 at every site at 512x512; at 1024x1024 the stride-4
# sites run K2 unclamped, their halo taken from the offsets; 480x480 and
# 1088x1920 (a 1080p frame) leave K1's envelope at every site (widths 120
# and 480 at stride 4) and run K2, clamped at R = 6 at 480's stride-4
# sites and unclamped elsewhere; 480x512 (a 512x480 frame) runs K1 at the
# stride-4 sites (width 128).  Those three split unevenly: 15 stride-32
# rows over 2 and 4 ranks (8/7, 4/4/4/3) and 34 over 4 (9/9/8/8).  Each
# rank holds K1 and K2 against their plain versions on the
# halo'd inputs its DCN sites were given (TOL_K1, TOL_K2, relative, as the
# kernel checks).  The gathered heads are held against the one-process
# forward at TOL_HEADS (two paths that sum in another order), the decoded
# rows matched as the export phase matches them (match_rows at
# test.vis_thresh): none may be left unmatched, but for bf16 at sizes
# other than 512x512 (run for the memory per rank), where a row left
# unmatched must have a row of the other run within one output cell and
# DEMO_SCORE, as the model
# check matches bf16 centers (an H100 run of 1x4 gave one: two
# neighbouring cells of the bf16 heatmap tied at 0.5039 on the shards and
# not in one process, 2.37 px apart); the f32 run of that 1x4 case holds
# the same unclamped path to every row.  Each rank that holds rows
# launches K1 and K2 at each site (Cin, Cout, W) as often as one process
# does; a rank with no rows launches none (a split of fewer stride-32 rows
# than ranks; no case here has one) and is printed, not gated.
SP_BATCH, SP_ITERS, SP_TIMEOUT = 2, 1, 600
SP_CASES = [("dla_34", "bfloat16", 512, (2, 4)),
            ("res_18", "float32", 512, (2,)),
            ("dla_34", "float32", 512, (2,)),
            ("dla_34", "bfloat16", 1024, (2, 4)),
            ("dla_34", "float32", 1024, (4,)),
            ("dla_34", "bfloat16", 480, (2, 4)),
            ("dla_34", "bfloat16", (480, 512), (4,)),
            ("dla_34", "bfloat16", (1080, 1920), (4,))]
SP_SNAPSHOTS = {"dla_34": NPZ, "res_18": ROOT / "output" /
                "res18_hard_artifact" / "params_f16.npz"}
# The offsets phase (tools/offsets_hist.py): synthetic val images.
OH_IMAGES = 8
# The ablation phase: tools/ablate_step at batch TRAIN_BATCH over
# ABL_ITERS calls per row (train rows max(1, ABL_ITERS // 2) steps), and
# tools/bench_input_pipeline over ABL_IMAGES images per loader run and
# ABL_SAMPLES rendered and encoded ones.  K1, K2 and backward launches per
# call of each row (16 DCN calls per forward; K1 one launch a call in
# bf16).  The unfused-om forward against the fused one on EXPORT_BATCH
# frames, two functions: the unfused site rounds its om conv to bf16 (a
# step of 0.25 cells at |dy| 32-64) where K1 keeps the offsets in f32.
# Their heads differ by a few bf16 steps at the worst pixel: max |a - b| /
# max |b| read 5.263e-2 on an H100 (8 frames) and 5.04e-2 at hm_hp with
# the plain versions on a CPU, whose relative L2 per head read 2.4e-3 to
# 4.0e-3; TOL_UNFUSED holds (max rel, relative L2) at about twice those.
# The decoded rows are matched as the export phase matches them.
ABL_ITERS, ABL_IMAGES, ABL_SAMPLES = 3, 16, 4
TOL_UNFUSED = (1e-1, 1e-2)
ABL_LAUNCHES = {"infer_full": (16, 0, 0), "infer_fwd_only": (16, 0, 0),
                "infer_fwd_unfused_om": (0, 16, 0), "trunk": (0, 0, 0),
                "infer_fwd_convsub": (0, 0, 0), "train_full": (0, 16, 16),
                "train_convsub": (0, 0, 0)}


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


# Cycles the card sleeps before a timed loop, so that the host has queued
# the calls before the first one starts and the events time the device
# alone (about 11 ms at an H100's 1.755 GHz; a host that needs longer to
# queue them shows its own dispatch in the time, as without the sleep).
QUEUE_CYCLES = 20_000_000


def cuda_ms_host(fn, iters: int):
    """(mean device ms, mean host us) of ``fn`` over ``iters`` calls: CUDA
    events around the calls, queued behind QUEUE_CYCLES of sleep, and the
    host clock around their enqueue, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e6 * host / iters


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (``cuda_ms_host``)."""
    return cuda_ms_host(fn, iters)[0]


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


def gather_bytes(b: int, hw: int, cin: int, fused: bool,
                 dtype: str = "bfloat16") -> float:
    """Bytes one call gathers (mostly from L2, some from L1): four corners
    of every (pixel, tap, channel) for the product, one for K1's om conv,
    in the dtype's width.  Beside the bound, not in it (the bound counts
    each input once)."""
    elem = 4 if dtype == "float32" else 2
    return elem * b * hw * hw * 9 * cin * (4 + (1 if fused else 0))


def plan_text(dtype, b: int, hw: int, cin: int, cout: int) -> str:
    from centerpose_tpu_torch.ops import dcn_cuda as dc

    p = dc.forward_plan(dtype, b, hw, hw, cin, cout)
    return (f"plan {p['kernel']} tile {p['tile_m']}x{p['n_pad']} split "
            f"{p['split']} stages {p['stages']} smem {p['smem']} grid "
            f"{p['grid'][0]} launches {p['launches']}")


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
    """K1 against its plain version at every site shape, batch 1 and 8, in
    float32 and bfloat16; returns the JSON entries (bf16 batch 1) keyed by
    site."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2_fused_plain

    entries = {}
    # K1 ms per forward (16 calls) by (dtype, batch)
    per_fwd = {(d, b): 0.0 for d in ("float32", "bfloat16") for b in (1, 8)}
    calls = {(cin, cout, hw): n for cin, cout, hw, n in SITES}
    cases = [(cin, cout, hw, dc.site_max_dy(hw, hw, cin, cout, "pallas_full"))
             for cin, cout, hw, _ in SITES]
    check([c[3] for c in cases] == [24, 12, 12, 12, 12, 12, 6],
          f"site policy at 512: {[c[3] for c in cases]}")
    cases.append((64, 64, 128, None))  # an unclamped site (the xla policy)
    for i, (cin, cout, hw, r) in enumerate(cases):
        for b, seed, iters, plain_iters in ((1, 100, 20, 5), (8, 200, 10, 3)):
            base = k1_inputs(seed + i, b, hw, cin, cout)
            for dtype in ("float32", "bfloat16"):
                args = on_card(base, getattr(torch, dtype))
                got = dc.dcn_v2_fused(*args, r)
                ref = dcn_v2_fused_plain(*args, r)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"K1 batch-{b} output not finite")
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                rel = err / max(scale, 1e-12)
                del got, ref
                clamped = ""
                if r is not None and b == 1:
                    om = torch.nn.functional.conv2d(
                        args[0].float().permute(0, 3, 1, 2),
                        args[1].float().permute(3, 2, 0, 1),
                        args[2].float(), padding=1)
                    frac = (om[:, 0:18:2].abs() > r).float().mean().item()
                    check(frac > 0.01, f"clamp not exercised at R={r}")
                    clamped = f"; |dy|>R at {frac:.1%} of taps"
                ms, host_us = cuda_ms_host(
                    lambda: dc.dcn_v2_fused(*args, r), iters)
                plain_ms = cuda_ms(lambda: dcn_v2_fused_plain(*args, r),
                                   plain_iters)
                bound_ms, bound_by = k1_bound(b, hw, cin, cout, dtype)
                batch = "" if b == 1 else " batch 8"
                say(f"  K1 {cin}->{cout} @{hw}x{hw} R={r} {dtype}{batch}: "
                    f"max_abs_err {err:.3e} (rel {rel:.2e}, tol "
                    f"{TOL_K1[dtype]:.0e}{clamped}) "
                    f"kernel {ms:.4f} ms (host {host_us:.1f} us a call) "
                    f"plain {plain_ms:.4f} ms "
                    f"bound {bound_ms:.5f} ms ({bound_by}); gathers "
                    f"{gather_bytes(b, hw, cin, True, dtype) / 1e6:.1f} MB; "
                    + plan_text(getattr(torch, dtype), b, hw, cin, cout))
                if r is not None:
                    per_fwd[(dtype, b)] += calls[(cin, cout, hw)] * ms
                check(rel <= TOL_K1[dtype], f"K1 {cin}->{cout} @{hw} "
                      f"{dtype} batch {b}: rel err {rel:.3e}")
                if dtype == "bfloat16" and b == 1 and r is not None:
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
                del args
    for dtype in ("float32", "bfloat16"):
        say(f"  K1 {dtype} per forward (16 calls, sum of the site times): "
            f"batch 1 {per_fwd[(dtype, 1)]:.4f} ms, batch 8 "
            f"{per_fwd[(dtype, 8)]:.4f} ms")
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


def export_phase(state_dict, card: str, device: str = "cuda"):
    """The deployment path: the flagship's serving function exported with
    ``torch.export`` at batch EXPORT_BATCH, saved, reloaded through the
    port's loader (``tools/export.load_serving``) and run, then compiled
    (``torch.compile``, fullgraph); then EXPORT_K2_CASES
    (``export_k2_case``).  Returns the K1 launch counts by site of the
    flagship's reloaded and compiled calls, and K2's of the K2 cases'
    reloaded calls."""
    import tempfile

    import numpy as np
    import torch

    from centerpose_tpu_torch.data.synthetic import render_scene
    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools.export import (export_serving,
                                                   load_serving,
                                                   save_serving)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    det = Detector(flagship_cfg(), state_dict, device=device)
    frames = [render_scene(np.random.default_rng(400 + i), 640, 480, 2)[0]
              for i in range(EXPORT_BATCH)]
    pre = [det.pre_process(f) for f in frames]
    x = torch.cat([p[0] for p in pre]).float()
    x = (x / 255.0 - det.mean) / det.std  # the program takes float32
    with torch.inference_mode():
        eager = det.process(x)
    t0 = time.perf_counter()
    program = export_serving(det, x)
    t_export = time.perf_counter() - t0
    op = torch.ops.centerpose.dcn_v2_fused.default
    calls = [n.target for n in program.graph.nodes
             if n.op == "call_function"]
    nodes = calls.count(op)
    asserts = calls.count(torch.ops.aten._assert_tensor_metadata.default)
    check(nodes == 16, f"export: {nodes} K1 nodes in the graph, not 16")
    per_call = dc.KERNELS_PER_CALL[torch.bfloat16]
    want_sites = {(cin, cout, hw, hw): n * per_call
                  for cin, cout, hw, n in SITES}
    launches, counted = {}, {}

    def run_counted(fn, what):
        dc.reset_launch_counts()
        out = fn(x)
        sync()
        sites = dict(dc.dcn_v2_fused.launches_by_site)
        counted[what] = dc.dcn_v2_fused.launches
        check(counted[what] == 16 * per_call and sites == want_sites,
              f"{what}: K1 launches {counted[what]} ({sites})")
        for site, n in sites.items():
            launches[site] = launches.get(site, 0) + n
        check(tuple(out.shape) == (EXPORT_BATCH, 100, 40)
              and bool(torch.isfinite(out).all()), f"{what}: {out.shape}")
        return out

    with tempfile.TemporaryDirectory(prefix="cp_export_") as tmp:
        path = str(Path(tmp) / "dla_34_b8.pt2")
        t0 = time.perf_counter()
        save_serving(program, det, path)
        t_save = time.perf_counter() - t0
        size_mb = Path(path).stat().st_size / 1e6
        t0 = time.perf_counter()
        served = load_serving(path)
        t_load = time.perf_counter() - t0
    reloaded = run_counted(served, "reloaded program")
    equal = torch.equal(reloaded, eager)
    say(f"  export dla_34 bf16 pallas_full batch {EXPORT_BATCH}: export "
        f"{t_export:.2f} s, save {t_save:.2f} s, load {t_load:.2f} s, "
        f"{size_mb:.2f} MB; graph {len(calls)} calls ({asserts} dtype "
        f"asserts), K1 nodes {nodes}; reloaded call K1 launches "
        f"{counted['reloaded program']}; rows bit-equal to Detector.process: "
        f"{equal}")
    check(equal, "export: the reloaded program's rows differ from "
          f"Detector.process's (max |diff| "
          f"{(reloaded - eager).abs().max().item():.3e})")

    engine = served.compiled()
    t0 = time.perf_counter()
    engine(x)
    sync()
    t_compile = time.perf_counter() - t0
    flops = served.flops(x)
    peak_mb = float("nan")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    compiled = run_counted(engine, "compiled program")
    if torch.device(device).type == "cuda":
        peak_mb = (torch.cuda.max_memory_allocated() - base
                   - compiled.numel() * compiled.element_size()) / 1e6
    n_conf = unmatched = 0
    worst_px = worst_score = 0.0
    a, b = compiled.cpu().numpy(), eager.cpu().numpy()
    for i, (_, meta) in enumerate(pre):
        rows_a = det.post_process(a[i:i + 1], meta)[1]
        rows_b = det.post_process(b[i:i + 1], meta)[1]
        n, u, px, ds = match_rows(rows_a, rows_b, det.cfg.test.vis_thresh)
        if u:
            for what, rows in (("compiled", rows_a), ("eager", rows_b)):
                top = rows[rows[:, 4] >= det.cfg.test.vis_thresh - 0.05]
                say(f"    frame {i} {what}: " + "; ".join(
                    f"score {r[4]:.4f} center ({(r[0] + r[2]) / 2:.3f}, "
                    f"{(r[1] + r[3]) / 2:.3f})" for r in top))
        n_conf += n
        unmatched += u
        worst_px, worst_score = max(worst_px, px), max(worst_score, ds)
    ms_compiled = cuda_ms(lambda: engine(x), 10)
    ms_reloaded = cuda_ms(lambda: served(x), 10)
    ms_eager = cuda_ms(lambda: det.process(x), 10)
    traced = {}
    if torch.device(device).type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for what, fn in (("eager", det.process), ("reloaded", served),
                         ("compiled", engine)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(x)
                sync()
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(r[0] for r in device_rows(prof))
            traced[what] = f"{busy:.3f} of {wall:.3f}"
    say(f"  AOT (torch.compile, fullgraph) of the reloaded program: compile "
        f"{t_compile:.2f} s; {flops:.4e} FLOPs per call (FlopCounterMode, "
        f"K1 by its formula); weights {served.weight_bytes() / 1e6:.1f} MB, "
        f"peak temp {peak_mb:.1f} MB; compiled call K1 launches "
        f"{counted['compiled program']}; ms per call (CUDA events, 10 calls): "
        f"compiled {ms_compiled:.3f}, reloaded {ms_reloaded:.3f}, eager "
        f"{ms_eager:.3f}; one traced call each, device busy of wall ms: "
        + ", ".join(f"{k} {v}" for k, v in traced.items()) + f"; {card}")
    say(f"  compiled rows vs Detector.process: {n_conf} rows score >= "
        f"{det.cfg.test.vis_thresh} on either side, {unmatched} unmatched, "
        f"worst center {worst_px:.3f} px, worst score diff {worst_score:.4f} "
        f"(limits {DEMO_PX} px, {DEMO_SCORE})")
    check(n_conf >= EXPORT_BATCH, f"export: only {n_conf} confident rows")
    check(unmatched == 0, f"export: {unmatched} of {n_conf} confident rows "
          "of the compiled program have no match in Detector.process's")
    k2_launches = {}
    for case in EXPORT_K2_CASES:
        for site, n in export_k2_case(state_dict, card, *case,
                                      device=device).items():
            k2_launches[site] = k2_launches.get(site, 0) + n
    return launches, k2_launches


def export_k2_case(state_dict, card: str, what: str, model: dict, size: int,
                   batch: int, k1_calls: int, k2_calls: int,
                   device: str = "cuda") -> dict:
    """The flagship's serving function with ``model`` overrides at
    ``size``, batch ``batch``, exported, saved, reloaded through
    ``load_serving`` and run: K1 and K2 operator nodes as eager's calls
    (``k1_calls``, ``k2_calls``), K1 and K2 launches by site of the
    reloaded call equal to eager's, rows bit-equal.  Returns K2's launches
    by site of the reloaded call."""
    import tempfile

    import numpy as np
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.data.synthetic import render_scene
    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools.export import (export_serving,
                                                   load_serving,
                                                   save_serving)

    cfg = update_config(flagship_cfg(), {"model": {
        **model, "input_res": size, "output_res": size // 4}})
    det = Detector(cfg, state_dict, device=device)
    frames = [render_scene(np.random.default_rng(450 + i), 640, 480, 2)[0]
              for i in range(batch)]
    x = torch.cat([det.pre_process(f)[0] for f in frames]).float()
    x = (x / 255.0 - det.mean) / det.std

    def counted(fn):
        dc.reset_launch_counts()
        out = fn(x)
        torch.cuda.synchronize()
        return out, {k.__name__: dict(k.launches_by_site)
                     for k in (dc.dcn_v2_fused, dc.dcn_v2)}

    with torch.inference_mode():
        eager, eager_sites = counted(det.process)
    per_call = dc.KERNELS_PER_CALL[torch.bfloat16]
    calls = (sum(eager_sites["dcn_v2_fused"].values()) // per_call,
             sum(eager_sites["dcn_v2"].values()))
    check(calls == (k1_calls, k2_calls),
          f"export {what}: eager K1, K2 calls {calls}, not "
          f"{(k1_calls, k2_calls)}")
    t0 = time.perf_counter()
    program = export_serving(det, x)
    t_export = time.perf_counter() - t0
    targets = [n.target for n in program.graph.nodes]
    nodes = (targets.count(torch.ops.centerpose.dcn_v2_fused.default),
             targets.count(torch.ops.centerpose.dcn_v2.default))
    check(nodes == calls, f"export {what}: K1, K2 nodes {nodes}, eager "
          f"calls {calls}")
    with tempfile.TemporaryDirectory(prefix="cp_export_k2_") as tmp:
        path = str(Path(tmp) / "program.pt2")
        save_serving(program, det, path)
        size_mb = Path(path).stat().st_size / 1e6
        served = load_serving(path)
    reloaded, sites = counted(served)
    equal = torch.equal(reloaded, eager)
    say(f"  export dla_34 bf16 {what}x{size} batch {batch}: export "
        f"{t_export:.2f} s, {size_mb:.2f} MB; K1, K2 nodes {nodes}; "
        f"reloaded call launches K1 {sum(sites['dcn_v2_fused'].values())} "
        f"K2 {sum(sites['dcn_v2'].values())}, by site as eager's: "
        f"{sites == eager_sites}; rows bit-equal to Detector.process: "
        f"{equal}; {card}")
    check(sites == eager_sites, f"export {what}: reloaded launches by site "
          f"{sites}, eager {eager_sites}")
    check(equal, f"export {what}: the reloaded program's rows differ from "
          f"Detector.process's (max |diff| "
          f"{(reloaded - eager).abs().max().item():.3e})")
    return sites["dcn_v2"]


def bench_phase(card: str) -> None:
    """The per-backbone bench suite (``tools/bench_suite``: dla_34
    pallas_full/bfloat16 infer at batch 1 and 8 and train at batch 8,
    res_18 bfloat16 infer at batch 1 and 8) and ``tools/bench_eval``'s
    video row (64 frames) and multi-scale flip row (8 images); every row
    printed with the card."""
    from centerpose_tpu_torch.tools import bench_eval, bench_suite

    rows = bench_suite.run(["dla_34"], ["infer", "train"], iters=BENCH_ITERS)
    rows += bench_suite.run(["res_18"], ["infer"], iters=BENCH_ITERS)
    rows += bench_eval.bench_video(BENCH_FRAMES)
    rows += bench_eval.bench_msflip_eval(BENCH_IMAGES)
    for row in rows:
        check(row["images_per_s"] > 0 and row["card"] == card,
              f"bench row {row}")
    say(f"  bench suite: {len(rows)} rows; {card}")


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
    site shape, float32 and bfloat16 at batch 1 and 8 (the training
    batch); K2's time per step in each.  Returns the JSON entries (bfloat16 batch 8, the training shapes) keyed
    by (kernel, site)."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2, dcn_v2_backward_plain

    entries = {}
    # K2 ms per step (16 calls) by (dtype, batch)
    k2_step = {(d, b): 0.0 for d in ("float32", "bfloat16")
               for b in (1, TRAIN_BATCH)}
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
                         ("float32", TRAIN_BATCH), ("bfloat16", TRAIN_BATCH)):
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
                + "; fwd gathers "
                f"{gather_bytes(b, hw, cin, False, dtype) / 1e6:.1f}"
                f" MB; fwd " + plan_text(dt, b, hw, cin, cout))
            for name, (_, rel) in errs.items():
                tol = (TOL_K2 if name == "y" else TOL_BWD)[dtype]
                check(rel <= tol, f"{name} {cin}->{cout} @{hw} {dtype}: rel "
                      f"err {rel:.3e} > {tol:.0e}")
            k2_step[(dtype, b)] += n_calls * ms
            if b != TRAIN_BATCH or dtype != "bfloat16":
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
    for dtype in ("float32", "bfloat16"):
        say(f"  K2 {dtype} per step (16 calls, sum of the site times): "
            f"batch 1 {k2_step[(dtype, 1)]:.4f} ms, batch {TRAIN_BATCH} "
            f"{k2_step[(dtype, TRAIN_BATCH)]:.4f} ms")
    return entries


def determinism_check():
    """Two calls on the same inputs give the same bits: the backward's
    gradients at every site shape, batch 8, in bfloat16 and float32; K1's
    y and om and K2's y at every site shape, batch 1 and 8, in bfloat16
    and float32 (split plans among them)."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc

    for i, (cin, cout, hw, _) in enumerate(SITES):
        r = dc.site_max_dy(hw, hw, cin, cout, "pallas_full")
        for b in (1, TRAIN_BATCH):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                args = on_card(k1_inputs(700 + i, b, hw, cin, cout), dt)
                y1, om1 = dc.launch_fused_forward(*args, r)
                y2, om2 = dc.launch_fused_forward(*args, r)
                x, off, mask, w, bias, _ = [
                    t.to("cuda", dt if j != 4 else torch.float32).contiguous()
                    for j, t in enumerate(k2_inputs(800 + i, b, hw, cin, cout,
                                                    r))]
                z1 = dc.dcn_v2(x, off, mask, w, bias, r)
                z2 = dc.dcn_v2(x, off, mask, w, bias, r)
                torch.cuda.synchronize()
                same = {"K1 y": bool(torch.equal(y1, y2)),
                        "K1 om": bool(torch.equal(om1, om2)),
                        "K2 y": bool(torch.equal(z1, z2))}
                split = dc.forward_plan(dt, b, hw, hw, cin, cout)["split"]
                say(f"  determinism {cin}->{cout} @{hw}x{hw} {dtype} batch "
                    f"{b} (split {split}): bit-equal "
                    + " ".join(f"{n}={v}" for n, v in same.items()))
                check(all(same.values()), f"forward not deterministic at "
                      f"{cin}->{cout} @{hw} {dtype} batch {b}: {same}")
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
    for row in ("xla_bf16", "pallas_full_f32", "xla_f32"):
        check(ref["cross_impl"][row]["model_path"].endswith(
            "params_f16.npz"), f"{row} anchor not on the npz")
    return {"single": ref["cross_impl"]["pallas_full_bf16"]["stats"]["AP"],
            "ms_flip_nms": ref["modes"]["ms_flip_nms"]["stats"]["AP"],
            **{row: ref["cross_impl"][row]["stats"]["AP"]
               for row in ("xla_bf16", "pallas_full_f32", "xla_f32")}}


def evaluation(state_dict, card: str):
    """The evaluation main path: the hard benchmark's 512 scenes drawn by
    the port's renderer, the bf16 pallas_full Detector (K1) over them at
    single scale and with flip and 3 scales (soft-NMS merge), OKS AP by the
    port's evaluator against the reference's; K1 must launch at every site
    in each mode.  Then two rows printed beside the reference's, not gated:
    xla bf16 (K2 at every site) and pallas_full float32 (K1 in float32,
    beside the reference's pallas_full and xla float32 rows)."""
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
             "xla_bf16": CROSS_IMPL["xla_bf16"],
             "pallas_full_f32": CROSS_IMPL["pallas_full_f32"]}
    for mode, opts in modes.items():
        cfg = flagship_config(opts)
        impl = "xla" if mode == "xla_bf16" else "pallas_full"
        dtype = "float32" if mode == "pallas_full_f32" else "bfloat16"
        check(cfg.model.dcn_impl == impl
              and cfg.model.compute_dtype == dtype, f"{mode} config")
        det = Detector(cfg, state_dict, device="cuda")
        det.run(ds.get_raw(0)[0])  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        dc.reset_launch_counts()
        results, times, wall = evaluate(det, ds)
        # pallas_full: K1 at every site; xla: the om conv, then K2
        kernel, other = ((dc.dcn_v2, dc.dcn_v2_fused) if impl == "xla"
                         else (dc.dcn_v2_fused, dc.dcn_v2))
        per_call = (1 if impl == "xla"
                    else dc.KERNELS_PER_CALL[getattr(torch, dtype)])
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
            f"{want[mode]:.4f}, diff {stats['AP'] - want[mode]:+.4f}"
            + (f"; reference xla_f32 {want['xla_f32']:.4f}"
               if dtype == "float32" else "") + "); "
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


def _dp_state(trainer) -> dict:
    """Host copies of a trainer's parameters and BatchNorm buffers."""
    return {n: t.detach().cpu().clone() for n, t in
            [*trainer.model.named_parameters(),
             *trainer.model.named_buffers()]}


def _dp_world_one(state_dict, batches) -> None:
    """The DDP Trainer at world size 1 on NCCL against the plain Trainer:
    DP_STEPS steps on the same batches, parameters and BatchNorm buffers
    bit-equal; ms per step of each (after a warm-up step of another
    Trainer)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from centerpose_tpu_torch.parallel.mesh import init_distributed
    from centerpose_tpu_torch.train.trainer import Trainer

    cfg = train_cfg()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # warm-up: the deterministic algorithms' first use at these shapes
        Trainer(cfg, state_dict, device="cuda").train_step(batches[0])
        with tempfile.TemporaryDirectory(prefix="cp_dp1_") as tmp:
            init_distributed(f"file://{tmp}/rdv", 1, 0, backend="nccl",
                             device="cuda", timeout=DP_TIMEOUT)
            try:
                runs = {}
                for name, group in (("plain", None),
                                    ("DDP", dist.group.WORLD)):
                    trainer = Trainer(cfg, state_dict, device="cuda",
                                      group=group)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for b in batches:
                        trainer.train_step(b)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
                    runs[name] = (ms, _dp_state(trainer))
                    del trainer
            finally:
                dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = prev
    (ms_p, plain), (ms_d, ddp) = runs["plain"], runs["DDP"]
    differ = [n for n in plain if not torch.equal(plain[n], ddp[n])]
    check(not differ, f"world-1 DDP differs from the plain Trainer at "
          f"{len(differ)} tensors, first {differ[:3]}")
    say(f"  world size 1 (nccl), batch {TRAIN_BATCH} bf16, {len(batches)} "
        f"steps: DDP {ms_d:.2f} ms per step, plain {ms_p:.2f} ms per step "
        f"(host clock, synchronised, cuDNN deterministic); {len(plain)} "
        "parameters and buffers bit-equal")


def dp_rank(rank: int, world: int, init: str, out: str) -> None:
    """One rank of the data-parallel phase's two-rank run on cuda:0 over
    gloo: its half of the 8 images of seed 31 through one f32 step (TF32
    off) and one bf16 step (backward only; the all-reduced gradients, the
    BatchNorm statistics and the loss), then DP_STEPS bf16 SGD steps on
    seeds 32, 33; writes them with its launch counts to ``out``."""
    import torch
    import torch.distributed as dist

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.parallel.mesh import init_distributed
    from centerpose_tpu_torch.train.trainer import Trainer
    from centerpose_tpu_torch.weights import state_dict_from_npz

    torch.cuda.set_device(0)
    init_distributed(init, world, rank, backend="gloo", device="cuda:0",
                     timeout=DP_TIMEOUT)
    try:
        group = dist.group.WORLD
        state_dict = state_dict_from_npz(str(NPZ))
        n = TRAIN_BATCH // world
        half = slice(rank * n, (rank + 1) * n)

        def mine(cfg, seed):
            return {k: v[half] for k, v in
                    train_batch(cfg, seed, TRAIN_BATCH).items()}

        res = {"steps": {}}
        dc.reset_launch_counts()
        for dtype in ("float32", "bfloat16"):
            trainer = Trainer(train_cfg(dtype), state_dict, device="cuda:0",
                              group=group)
            stats = trainer.backward(mine(trainer.cfg, 31))
            torch.cuda.synchronize()
            grads = {n: None if p.grad is None else p.grad.detach().cpu()
                     for n, p in trainer.model.named_parameters()}
            bstats = {n: t.detach().cpu()
                      for n, t in trainer.model.state_dict().items()
                      if n.endswith(("running_mean", "running_var"))}
            res["steps"][dtype] = (float(stats["loss"]), grads, bstats)
            del trainer
        cfg = update_config(train_cfg(), {"train": {"optimizer": "sgd"}})
        trainer = Trainer(cfg, state_dict, device="cuda:0", group=group)
        for seed in range(32, 32 + DP_STEPS):
            trainer.train_step(mine(cfg, seed))
        torch.cuda.synchronize()
        res["state"] = _dp_state(trainer)
        res["steps_run"] = 2 + DP_STEPS
        res["launches"] = {
            "dcn_v2": dict(dc.dcn_v2.launches_by_site),
            "dcn_v2_backward": dict(dc.dcn_v2_backward.launches_by_site),
            "k1": dc.dcn_v2_fused.launches}
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _start_ranks(cmds, env_of):
    """Start one process per command (``env_of(rank)`` its environment),
    output to a pipe."""
    import os

    return [subprocess.Popen(cmd, cwd=str(ROOT), env={**os.environ,
                                                      **env_of(r)},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r, cmd in enumerate(cmds)]


def _wait_ranks(procs, what: str, timeout: float = DP_TIMEOUT) -> list:
    """Each process's output once all have ended; fails the phase when one
    failed or outlived ``timeout`` seconds (then all are killed)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        outs.append(f"timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    check(not failed, f"{what}: rank(s) {failed} failed\n"
          + "\n".join(o[-3000:] for o in outs))
    return outs


def _dp_two_ranks(state_dict, tmp: Path) -> dict:
    """The two-rank step on one card (gloo) against the one-process
    Trainer; returns the ranks' launch counts by (kernel, site), summed."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.train.trainer import Trainer

    def one_process(dtype, order):
        cfg = train_cfg(dtype)
        batch = train_batch(cfg, 31, TRAIN_BATCH)
        trainer = Trainer(cfg, state_dict, device="cuda")
        stats = trainer.backward({k: v[order] for k, v in batch.items()})
        torch.cuda.synchronize()
        return (float(stats["loss"]),
                {n: None if p.grad is None else p.grad.detach().cpu()
                 for n, p in trainer.model.named_parameters()},
                {n: t.detach().cpu()
                 for n, t in trainer.model.state_dict().items()
                 if n.endswith(("running_mean", "running_var"))})

    # the one-process step, and as a control of its summation-order noise
    # the same step with the batch's halves swapped
    half = TRAIN_BATCH // 2
    order = np.arange(TRAIN_BATCH)
    ref = {dtype: one_process(dtype, order)
           for dtype in ("float32", "bfloat16")}
    floor = {dtype: _step_gaps(one_process(dtype, np.roll(order, half)),
                               ref[dtype])
             for dtype in ("float32", "bfloat16")}
    torch.cuda.empty_cache()
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    init = f"file://{tmp}/rdv2"
    t0 = time.perf_counter()
    _wait_ranks(_start_ranks(
        [[sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(r),
          "--dp-world", "2", "--dp-init", init, "--dp-out", outs[r]]
         for r in range(2)], lambda r: {}), "two-rank step")
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(o, weights_only=False) for o in outs]

    for dtype in ("float32", "bfloat16"):
        a, b = (r["steps"][dtype] for r in ranks)
        check(a[0] == b[0] and all(
            (a[1][n] is None and b[1][n] is None) or torch.equal(a[1][n],
                                                                 b[1][n])
            for n in a[1]), f"{dtype}: the ranks' all-reduced gradients "
              "or global loss differ")
        loss_rel, stat_err, rows, total = _step_gaps(a, ref[dtype])
        median = float(np.median([r[0] for r in rows]))
        f_rows, f_total = floor[dtype][2], floor[dtype][3]
        f_median = float(np.median([r[0] for r in f_rows]))
        say(f"  two ranks x {half} (gloo, one card) against one process x "
            f"{TRAIN_BATCH}, {dtype} step: loss {a[0]:.6f} / "
            f"{ref[dtype][0]:.6f} (rel {loss_rel:.2e}); BatchNorm "
            f"statistics max rel err {stat_err:.2e}; gradients of "
            f"{len(rows)} tensors: L2 rel err of all {total:.2e}, worst "
            f"{rows[0][0]:.2e} ({rows[0][2]}), median {median:.2e}; one "
            f"process with the halves swapped: loss {floor[dtype][0]:.2e}, "
            f"statistics {floor[dtype][1]:.2e}, gradients all "
            f"{f_total:.2e}, worst {f_rows[0][0]:.2e} ({f_rows[0][2]}), "
            f"median {f_median:.2e}")
        if dtype == "float32":
            # a tensor whose gradient sums cancelling terms (a BatchNorm
            # bias) may read above TOL_TRAIN_GRAD_L2 from the order of
            # the sums alone: held to twice the control's worst there
            worst_tol = max(TOL_TRAIN_GRAD_L2, 2 * f_rows[0][0])
            check(loss_rel <= TOL_TRAIN_LOSS
                  and stat_err <= TOL_TRAIN_STATS
                  and total <= TOL_TRAIN_GRAD_L2
                  and rows[0][0] <= worst_tol,
                  f"two-rank f32 step: loss {loss_rel:.3e}, statistics "
                  f"{stat_err:.3e}, gradients all {total:.3e}, worst "
                  f"{rows[0]} (limit {worst_tol:.3e})")
        else:
            # the bf16 step's order noise alone (one bf16 rounding moved
            # by a last bit of a statistic) may reach TOL_TRAIN_BF16: held
            # to twice the control's there
            tol = {"total": max(TOL_TRAIN_BF16["grad_l2"], 2 * f_total),
                   "median": max(TOL_TRAIN_BF16["grad_l2"], 2 * f_median)}
            check(loss_rel <= TOL_TRAIN_BF16["loss"]
                  and stat_err <= TOL_TRAIN_BF16["stats"]
                  and total <= tol["total"] and median <= tol["median"],
                  f"two-rank bf16 step: loss {loss_rel:.3e}, statistics "
                  f"{stat_err:.3e}, gradients all {total:.3e} median "
                  f"{median:.3e} (limits {tol})")
    s0, s1 = ranks[0]["state"], ranks[1]["state"]
    differ = [n for n in s0 if not torch.equal(s0[n], s1[n])]
    check(not differ, f"after {DP_STEPS} SGD steps the ranks differ at "
          f"{len(differ)} tensors, first {differ[:3]}")
    want = {(cin, cout, hw, hw): k for cin, cout, hw, k in SITES}
    totals = {"dcn_v2": {}, "dcn_v2_backward": {}}
    for r, res in enumerate(ranks):
        steps = res["steps_run"]
        for kernel in totals:
            by_site = res["launches"][kernel]
            check(by_site == {site: k * steps for site, k in want.items()},
                  f"rank {r}: {kernel} launches by site {by_site} for "
                  f"{steps} steps")
            for site, v in by_site.items():
                totals[kernel][site] = totals[kernel].get(site, 0) + v
        check(res["launches"]["k1"] == 0, f"rank {r}: K1 launched in training")
    say(f"  two ranks: {DP_STEPS} SGD steps, {len(s0)} parameters and "
        f"buffers bit-identical on the ranks; K2 and backward launches per "
        f"rank {sum(ranks[0]['launches']['dcn_v2'].values())} and "
        f"{sum(ranks[0]['launches']['dcn_v2_backward'].values())} for "
        f"{ranks[0]['steps_run']} steps (16 each per step); ranks' wall "
        f"{t_ranks:.2f} s")
    return totals


# tools/train.py main() in a rank process, its launch counts and summary
# written to the file named by argv[1]
_DP_CLI = """
import json, sys
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.tools import train
run = train.main(sys.argv[2:])
json.dump({"k1": dc.dcn_v2_fused.launches, "k2": dc.dcn_v2.launches,
           "bwd": dc.dcn_v2_backward.launches, "steps": run["trainer"].step,
           "epochs": run["epochs"]}, open(sys.argv[1], "w"))
"""


def _dp_cli(card: str, tmp: Path) -> None:
    """tools/train.py --multihost on two ranks over gloo on cuda:0: the
    files (rank 0's alone), finite losses, K2 and the backward at every
    step, K1 in rank 0's AP pass; global images/s (shared device)."""
    import numpy as np

    from centerpose_tpu_torch.eval.harness import BUCKET_CAP
    from centerpose_tpu_torch.tools.bench_scaling import _free_port

    out = tmp / "cli"
    argv = ["--multihost", "--dist-backend", "gloo", "--device", "cuda:0",
            "--synthetic", "--hard", "--synthetic-size",
            str(DP_CLI_STEPS * TRAIN_BATCH), "train.batch_size",
            str(TRAIN_BATCH), "train.num_workers", str(DP_CLI_WORKERS),
            "train.epochs", "1", "train.val_intervals", "1",
            "train.val_ap_limit", str(CLI_AP_LIMIT), "output_dir", str(out),
            "exp_id", "dp"]
    port = str(_free_port())
    results = [tmp / f"cli_rank{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    _wait_ranks(_start_ranks(
        [[sys.executable, "-c", _DP_CLI, str(results[r]), *argv]
         for r in range(2)],
        lambda r: {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}),
        "tools/train.py --multihost")
    wall = time.perf_counter() - t0
    runs = [json.loads(p.read_text()) for p in results]
    log_dir = out / "dp"
    files = sorted(p.name for p in log_dir.iterdir())
    # one config dump, and TensorBoard's events file where it imports
    opt = [f for f in files if f.startswith("opt_")]
    tb = [f for f in files if f.startswith("events.out.")]
    check(len(opt) == 1 and len(tb) <= 1 and set(files) - {*opt, *tb} == {
        "log.txt", "scalars.jsonl", "model_last", "model_last.meta.json",
        "model_best", "model_best.meta.json"},
          f"--multihost run directory holds {files}: rank 0's files only")
    log = (log_dir / "log.txt").read_text()
    check(log.count("| done") == 1 and log.count("train epoch 1") == 1,
          "log.txt must hold one rank's lines")
    scalars = [json.loads(line) for line in
               (log_dir / "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in scalars if r["tag"] == "train/loss"]
    check(len(losses) == 1 and all(np.isfinite(losses)),
          f"--multihost train losses {losses}")
    for r, run in enumerate(runs):
        check(run["steps"] == DP_CLI_STEPS
              and run["k2"] == 16 * DP_CLI_STEPS
              and run["bwd"] == 16 * DP_CLI_STEPS,
              f"--multihost rank {r}: {run['steps']} steps, K2 {run['k2']}, "
              f"backward {run['bwd']}")
    # K1 in each rank's share of the validation loss (eval mode, the
    # tool's val split of max(32, n / 8) images), and in rank 0's AP pass
    val_steps = max(32, DP_CLI_STEPS * TRAIN_BATCH // 8) // TRAIN_BATCH
    ap_forwards = -(-CLI_AP_LIMIT // BUCKET_CAP)
    check(runs[1]["k1"] == 16 * val_steps
          and runs[0]["k1"] - runs[1]["k1"] >= 16 * ap_forwards,
          f"--multihost K1 launches {runs[0]['k1']} / {runs[1]['k1']}: "
          f"{16 * val_steps} each in the val loss, at least "
          f"{16 * ap_forwards} more on rank 0 in the AP pass")
    e = runs[0]["epochs"][0]
    say(f"  tools/train.py --multihost, 2 ranks (gloo) sharing one card, "
        f"global batch {TRAIN_BATCH}, {DP_CLI_STEPS} steps: "
        f"{e['img_per_s']:.2f} global images/s shared-device (not "
        f"scaling), data_wait_frac {e['data_wait_frac']:.4f}, loss "
        f"{e['loss']:.4f}, val AP {e.get('AP', float('nan')):.4f}; K1 "
        f"{runs[0]['k1']} / {runs[1]['k1']} on ranks 0 / 1; run wall "
        f"{wall:.2f} s; {card}")


def _dp_bench(card: str) -> None:
    """tools/bench_scaling.py --nprocs 1 on the card (nccl)."""
    import math

    proc = subprocess.run(
        [sys.executable, "-m", "centerpose_tpu_torch.tools.bench_scaling",
         "--nprocs", "1", "--per-gpu-batch", str(TRAIN_BATCH), "--iters",
         str(DP_BENCH_ITERS)], cwd=str(ROOT), capture_output=True,
        text=True, timeout=DP_TIMEOUT)
    check(proc.returncode == 0, "bench_scaling failed:\n"
          + proc.stdout[-3000:] + proc.stderr[-3000:])
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    check(len(rows) == 1 and rows[0].get("world_size") == 1
          and rows[0]["backend"] == "nccl"
          and math.isfinite(rows[0]["images_per_s"])
          and rows[0]["images_per_s"] > 0, f"bench_scaling rows {rows}")
    say(f"  bench_scaling --nprocs 1 (flagship, random weights, "
        f"{DP_BENCH_ITERS} steps): {json.dumps(rows[0])}; {card}")


def data_parallel(state_dict, card: str) -> dict:
    """The data-parallel training main path (``parallel/mesh.py``): world
    size 1 on NCCL, two ranks on the one card over gloo, the CLI on two
    ranks, bench_scaling at world size 1.  Returns the two-rank step's
    launch counts by (kernel, site)."""
    import tempfile

    cfg = train_cfg()
    batches = [train_batch(cfg, 40 + i, TRAIN_BATCH) for i in range(DP_STEPS)]
    t = [time.perf_counter()]
    _dp_world_one(state_dict, batches)
    t.append(time.perf_counter())
    with tempfile.TemporaryDirectory(prefix="cp_dp_") as tmp:
        launches = _dp_two_ranks(state_dict, Path(tmp))
        t.append(time.perf_counter())
        _dp_cli(card, Path(tmp))
        t.append(time.perf_counter())
    _dp_bench(card)
    t.append(time.perf_counter())
    say("  data-parallel parts, s: world size 1 {:.2f}, two-rank step "
        "{:.2f}, --multihost {:.2f}, bench_scaling {:.2f}".format(
            *(b - a for a, b in zip(t, t[1:]))))
    return launches


def sp_cfg(name: str, dtype: str, size):
    """A spatial case's config: dla_34 the flagship's (pallas_full), other
    names the defaults with ``model.name``; ``dtype``, and fix_res at
    ``size`` x ``size`` or, for a size (h, w), keep_res padded to 32."""
    from centerpose_tpu_torch.config import default_config, update_config

    base = flagship_cfg() if name == "dla_34" else default_config()
    if isinstance(size, tuple):
        return update_config(base, {
            "model": {"name": name, "compute_dtype": dtype},
            "test": {"keep_res": True, "pad_bucket": 32}})
    return update_config(base, {"model": {
        "name": name, "compute_dtype": dtype, "input_res": size,
        "output_res": size // 4}})


def sp_frames(det, size):
    """SP_BATCH synthetic frames (640x480, or w x h for a size (h, w))
    pre-processed by ``det`` (uint8 [B, H, W, 3] on the card) and their
    metas."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.data.synthetic import render_scene

    h, w = size if isinstance(size, tuple) else (480, 640)
    pre = [det.pre_process(render_scene(np.random.default_rng(500 + i),
                                        w, h, 2)[0])
           for i in range(SP_BATCH)]
    return torch.cat([p[0] for p in pre]), [p[1] for p in pre]


def sp_name(size) -> str:
    """A case's input size, and its frame under keep_res."""
    if not isinstance(size, tuple):
        return f"{size}x{size}"
    h, w = size
    return f"{-(-h // 32) * 32}x{w} (keep_res, a {w}x{h} frame)"


def wall_ms(fn, iters: int) -> float:
    """Mean wall time of ``fn`` over ``iters`` calls, the card synchronised
    (after one warm-up call): the sharded forward waits on the host's
    exchanges, so the two forwards are timed alike."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def sp_run(det, images):
    """One case on ``det`` (sharded where it has a mesh): the heads of the
    normalised images (the second forward, and the first), the decoded
    rows (``Detector.process``, counted: K1's and K2's launches by (Cin,
    Cout, W) and in all), the image rows this rank holds, ms per
    ``process`` call and the peak MB allocated above what the case started
    with."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc

    x = (images.float() / 255.0 - det.mean) / det.std
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        net = det.net
        heads = [det.model(x) if net.sharding is None
                 else net.sharding.forward(det.model, x) for _ in range(2)]
        dc.reset_launch_counts()
        dets = det.process(images)
        torch.cuda.synchronize()
    by_site = {}
    for fn in (dc.dcn_v2_fused, dc.dcn_v2):
        by_site[fn.__name__] = site = {}
        for (cin, cout, _, w), n in fn.launches_by_site.items():
            site[(cin, cout, w)] = site.get((cin, cout, w), 0) + n
    k1, k2 = dc.dcn_v2_fused.launches, dc.dcn_v2.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    ms = wall_ms(lambda: det.process(images), SP_ITERS)
    first, heads = ({k: v.float().cpu() for k, v in h.items()}
                    for h in heads)
    shards = None if net.sharding is None else net.sharding.rows(images)
    rows = (images.shape[1] if shards is None
            else shards.rows[shards.index])
    return {"heads": heads, "first": first, "dets": dets.cpu().numpy(),
            "k1": k1, "k2": k2, "k1_sites": by_site["dcn_v2_fused"],
            "k2_sites": by_site["dcn_v2"], "rows": rows, "ms": ms,
            "peak_mb": peak}


def sp_record():
    """Wrap ``models/dla.py``'s K1 and K2 names so that the first call at
    each set of input shapes, dtype and clamp radius is kept: returns the
    kept ``(name, args)`` and a function that puts the names back."""
    from centerpose_tpu_torch.models import dla

    kept, seen = [], set()
    orig = {"dcn_v2_fused": dla.dcn_v2_fused, "dcn_v2": dla.dcn_v2}

    def wrap(name):
        def call(*args):
            key = (name, args[0].dtype, args[5],
                   *(tuple(a.shape) for a in args[:5]))
            if key not in seen:
                seen.add(key)
                kept.append((name, args))
            return orig[name](*args)
        return call

    for name in orig:
        setattr(dla, name, wrap(name))
    return kept, lambda: [setattr(dla, n, f) for n, f in orig.items()]


def sp_kernel_check(kept) -> list:
    """Each kept DCN call's kernel (K1 or K2) against its plain version on
    the same inputs: [(name, x shape, R, rel err, tol)], the error relative
    to the plain output's largest magnitude, as the kernel checks read it.
    Launches made here are not counted (``sp_run`` read them before)."""
    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.ops.dcn import dcn_v2, dcn_v2_fused_plain

    pairs = {"dcn_v2_fused": (dc.dcn_v2_fused, dcn_v2_fused_plain, TOL_K1),
             "dcn_v2": (dc.dcn_v2, dcn_v2, TOL_K2)}
    out = []
    with torch.inference_mode():
        for name, args in kept:
            kernel, plain, tol = pairs[name]
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            check(got.shape == ref.shape and finite,
                  f"spatial {name} at {tuple(args[0].shape)}: output "
                  f"{tuple(got.shape)}, finite {finite}")
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-12)
            out.append((name, tuple(args[0].shape), args[5], rel,
                        tol[str(args[0].dtype).split(".")[-1]]))
    return out


def sp_rank(rank: int, world: int, init: str, out: str) -> None:
    """One rank of the spatial phase: a 1 x ``world`` mesh on cuda:0 over
    gloo, every case whose meshes include ``world`` through a sharded
    ``Detector`` (``mesh=``), then its DCN sites' kernels against their
    plain versions on the inputs one more ``process()`` call of the same
    frames gave them (``sp_kernel_check``); writes the results to
    ``out``."""
    import torch

    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.parallel.mesh import (create_mesh_2d,
                                                    init_distributed)
    from centerpose_tpu_torch.weights import state_dict_from_npz

    torch.cuda.set_device(0)
    init_distributed(init, world, rank, backend="gloo", device="cuda:0",
                     timeout=SP_TIMEOUT)
    try:
        mesh = create_mesh_2d(1, world)
        res = {}
        for name, dtype, size, meshes in SP_CASES:
            if world not in meshes:
                continue
            det = Detector(sp_cfg(name, dtype, size),
                           state_dict_from_npz(str(SP_SNAPSHOTS[name])),
                           device="cuda", mesh=mesh)
            images, _ = sp_frames(det, size)
            res[(name, dtype, size)] = sp_run(det, images)
            # one more call, its DCN inputs kept (after sp_run's peak)
            kept, restore = sp_record()
            try:
                with torch.inference_mode():
                    det.process(images)
            finally:
                restore()
            res[(name, dtype, size)]["kernels"] = sp_kernel_check(kept)
            del det, kept
        torch.save(res, out)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def spatial_phase(card: str) -> dict:
    """The spatial-sharding main path: every SP_CASES case in one process
    (the reference, with two controls of its summation-order noise: the
    batch order swapped, and each image alone), then on 1 x 2 and 1 x 4
    meshes of ranks sharing the card (``chip_smoke.py --sp-rank R ...``,
    one launch of ranks per width).  Checks the gathered heads, the
    decoded rows, every rank's heads equal, the kernels' launches of each
    rank that holds rows against one process's, and K1 at every DCN site
    of the 512x512 bf16 dla_34 runs.  Returns K1's launches of those runs
    by (Cin, Cout, W) over the ranks."""
    import tempfile

    import numpy as np
    import torch

    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.weights import state_dict_from_npz

    one, controls, metas, alone_dets = {}, {}, {}, {}
    for name, dtype, size, _ in SP_CASES:
        key = (name, dtype, size)
        det = Detector(sp_cfg(name, dtype, size),
                       state_dict_from_npz(str(SP_SNAPSHOTS[name])),
                       device="cuda")
        images, metas[key] = sp_frames(det, size)
        one[key] = sp_run(det, images)
        x = (images.float() / 255.0 - det.mean) / det.std
        with torch.inference_mode():
            swapped = {k: v.flip(0).float().cpu()
                       for k, v in det.model(x.flip(0)).items()}
            alone = [det.model(x[i:i + 1]) for i in range(SP_BATCH)]
            alone = {k: torch.cat([a[k] for a in alone]).float().cpu()
                     for k in alone[0]}
            alone_dets[key] = np.concatenate(
                [det.process(images[i:i + 1]).cpu().numpy()
                 for i in range(SP_BATCH)])
        ref = one[key]["heads"]
        controls[key] = (head_rel_err(one[key]["first"], ref),
                         head_rel_err(swapped, ref),
                         head_rel_err(alone, ref))
        del det
    sharded = {}
    with tempfile.TemporaryDirectory(prefix="cp_sp_") as tmp:
        for world in sorted({n for *_, ns in SP_CASES for n in ns}):
            outs = [str(Path(tmp) / f"w{world}_r{r}.pt")
                    for r in range(world)]
            init = f"file://{tmp}/rdv_{world}"
            procs = _start_ranks(
                [[sys.executable, str(ROOT / "chip_smoke.py"), "--sp-rank",
                  str(r), "--sp-world", str(world), "--sp-init", init,
                  "--sp-out", outs[r]] for r in range(world)],
                lambda r: {})
            t0 = time.perf_counter()
            _wait_ranks(procs, f"spatial 1x{world}", SP_TIMEOUT)
            say(f"  1x{world} ranks ran in {time.perf_counter() - t0:.2f} s")
            sharded[world] = [torch.load(o, weights_only=False)
                              for o in outs]
    k1_sites, failed = {}, []
    for name, dtype, size, meshes in SP_CASES:
        key = (name, dtype, size)
        ref = one[key]
        vis = sp_cfg(name, dtype, size).test.vis_thresh
        twice_err, swap_err, alone_err = controls[key]
        ctl = _rows_matched(alone_dets[key], ref["dets"], metas[key], vis)
        for world in meshes:
            ranks = [r[key] for r in sharded[world]]
            got = ranks[0]
            err = head_rel_err(got["heads"], ref["heads"])
            same = all(all(torch.equal(r["heads"][k], got["heads"][k])
                           for k in got["heads"]) for r in ranks[1:])
            n_conf, unmatched, worst_px, worst_score, far = _rows_matched(
                got["dets"], ref["dets"], metas[key], vis)
            k1 = sum(r["k1"] for r in ranks)
            k2 = sum(r["k2"] for r in ranks)
            where = f"{name} {dtype} {sp_name(size)}"
            checked = [c for r in ranks for c in r["kernels"]]
            for kname in sorted({c[0] for c in checked}):
                mine = [c for c in checked if c[0] == kname]
                worst = max(mine, key=lambda c: c[3] / c[4])
                say(f"  spatial {where} 1x{world}: "
                    f"{kname} against its plain version on the {len(mine)} "
                    f"halo'd input shapes the ranks' sites gave it (x "
                    + ", ".join(f"{list(c[1])} R={c[2]}" for c in mine)
                    + f"): worst rel err {worst[3]:.3e} at {list(worst[1])} "
                    f"(tol {worst[4]:.0e})")
            for kname, shape, r, rel, tol in checked:
                if rel > tol:
                    failed.append(f"spatial {key} 1x{world}: {kname} at "
                                  f"{list(shape)} R={r} rel err {rel:.3e}")
            for kname, n in (("dcn_v2_fused", ref["k1"]),
                              ("dcn_v2", ref["k2"])):
                if n and not any(c[0] == kname for c in checked):
                    failed.append(f"spatial {key} 1x{world}: one process "
                                  f"launched {kname}, no rank's call of it "
                                  f"was checked")
            for i, r in enumerate(ranks):
                if not r["rows"]:
                    say(f"  spatial {where} 1x{world}: rank {i} holds no "
                        f"rows: K1 {r['k1']}, K2 {r['k2']} launches (a rank "
                        f"with no rows launches no kernel; not gated)")
                elif (r["k1_sites"], r["k2_sites"]) != (ref["k1_sites"],
                                                        ref["k2_sites"]):
                    failed.append(
                        f"spatial {key} 1x{world}: rank {i} ({r['rows']} "
                        f"rows) launched K1 {r['k1_sites']} K2 "
                        f"{r['k2_sites']} by site, one process K1 "
                        f"{ref['k1_sites']} K2 {ref['k2_sites']}")
            big = max(ranks, key=lambda r: r["rows"])
            small = min(ranks, key=lambda r: r["rows"])
            say(f"  spatial {where} batch {SP_BATCH} "
                f"1x{world}: heads rel err vs one process {err:.3e} (tol "
                f"{TOL_HEADS[dtype]:.0e}; controls: the first call "
                f"{twice_err:.3e}, batch order swapped {swap_err:.3e}, each "
                f"image alone {alone_err:.3e}); ranks' heads equal {same}; "
                f"rows: {n_conf} score >= {vis} on either side, {unmatched} "
                f"unmatched ({far} beyond a cell), worst center "
                f"{worst_px:.3f} px, score "
                f"{worst_score:.4f} (control, each image alone: {ctl[0]}, "
                f"{ctl[1]} unmatched, {ctl[2]:.3f} px, {ctl[3]:.4f}); ms per "
                f"process() {got['ms']:.2f} sharded (rank 0) vs "
                f"{ref['ms']:.2f} one process; peak MB per rank "
                + "/".join(f"{r['peak_mb']:.1f}" for r in ranks)
                + f" vs {ref['peak_mb']:.1f} one process (largest shard, "
                f"{big['rows']} image rows: {big['peak_mb']:.1f}; smallest, "
                f"{small['rows']}: {small['peak_mb']:.1f}); rows per rank "
                + "/".join(str(r["rows"]) for r in ranks)
                + f"; launches over the ranks K1 {k1}, K2 {k2} (one process "
                f"K1 {ref['k1']}, K2 {ref['k2']}; per rank K1 "
                + "/".join(str(r["k1"]) for r in ranks) + ", K2 "
                + "/".join(str(r["k2"]) for r in ranks) + f"); {card}")
            what = f"spatial {key} 1x{world}"
            if err > TOL_HEADS[dtype]:
                failed.append(f"{what}: heads rel err {err:.3e}")
            if not same:
                failed.append(f"{what}: the ranks' heads differ")
            if n_conf < 1 or far or (unmatched and (
                    size == 512 or dtype == "float32")):  # see SP_CASES
                failed.append(f"{what}: {unmatched} of {n_conf} rows "
                              f"unmatched, {far} beyond a cell")
            if name == "dla_34" and dtype == "bfloat16" and size == 512:
                for r in ranks:
                    check(set(r["k1_sites"]) == {(cin, cout, hw) for
                                                 cin, cout, hw, _ in SITES},
                          f"spatial 1x{world}: K1 sites {r['k1_sites']}")
                    for site, n in r["k1_sites"].items():
                        k1_sites[site] = k1_sites.get(site, 0) + n
    check(not failed, "; ".join(failed))
    return k1_sites


def _rows_matched(a, b, metas, vis: float):
    """``match_rows`` summed over the frames of two runs' decoded rows
    [B, K, 40]: (rows, unmatched, worst px, worst score, unmatched rows
    with no row of the other run within one output cell and DEMO_SCORE);
    each unmatched row is printed with the other run's nearest."""
    import numpy as np

    n_all = u_all = far = 0
    worst_px = worst_score = 0.0
    for i, meta in enumerate(metas):
        ra = _frame_rows(a[i:i + 1], meta)
        rb = _frame_rows(b[i:i + 1], meta)
        n, u, px, ds = match_rows(ra, rb, vis)
        n_all, u_all = n_all + n, u_all + u
        worst_px, worst_score = max(worst_px, px), max(worst_score, ds)
        if not u:
            continue
        cell = float(np.max(meta["s"])) / meta["out_width"]
        for s1, s2, side in ((ra, rb, "a"), (rb, ra, "b")):
            c2 = (s2[:, 0:2] + s2[:, 2:4]) / 2
            for row in s1[s1[:, 4] >= vis]:
                d = np.abs(c2 - (row[0:2] + row[2:4]) / 2).max(1)
                ds = np.abs(s2[:, 4] - row[4])
                if ((d <= DEMO_PX) & (ds <= DEMO_SCORE)).any():
                    continue
                near = (d <= cell) & (ds <= DEMO_SCORE)
                far += not near.any()
                j = int(np.argmin(d))
                say(f"    frame {i}: unmatched row of {side}, score "
                    f"{row[4]:.4f}, center {(row[0:2] + row[2:4]) / 2}; "
                    f"the other's nearest {d[j]:.3f} px away (a cell is "
                    f"{cell:.3f} px), score {s2[j, 4]:.4f}")
    return n_all, u_all, worst_px, worst_score, far


def head_rel_err(a: dict, b: dict) -> float:
    """The worst head's max |a - b| / max |b|."""
    return max(((a[k] - b[k]).abs().max() / b[k].abs().max()).item()
               for k in b)


def _frame_rows(dets, meta):
    """Decoded [1, K, 40] rows of one frame -> [K, 39] image pixels
    (``Detector.post_process`` at scale 1)."""
    from centerpose_tpu_torch.inference.post_process import (
        multi_pose_post_process)

    return multi_pose_post_process(dets, [meta["c"]], [meta["s"]],
                                   meta["out_height"],
                                   meta["out_width"])[0][1]


def offsets_phase(card: str) -> dict:
    """``tools/offsets_hist`` on the snapshot (the reference tool's config:
    pallas_full, bf16, 512x512) over OH_IMAGES synthetic val images,
    ``--skip-ap``: every site's row (16) finite, every fraction in [0,
    1]; K1 launched at every site (its ``om`` is what the tool reads).
    Returns K1's launches by (Cin, Cout, W)."""
    import math
    import tempfile

    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools import offsets_hist

    with tempfile.TemporaryDirectory(prefix="cp_oh_") as tmp:
        dc.reset_launch_counts()
        t0 = time.perf_counter()
        out = offsets_hist.main(["--images", str(OH_IMAGES), "--skip-ap",
                                 "--json", str(Path(tmp) / "oh.json")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {}
    for (cin, cout, _, w), n in dc.dcn_v2_fused.launches_by_site.items():
        launches[(cin, cout, w)] = launches.get((cin, cout, w), 0) + n
    sites = out["sites"]
    fracs = ("frac_dy_gt1", "frac_dy_gt4", "frac_dy_clamped")
    check(len(sites) == 16, f"offsets: {len(sites)} sites, not 16")
    for row in sites:
        values = [v for k, v in row.items() if k not in ("site", "shape")]
        check(all(math.isfinite(v) for v in values)
              and all(0.0 <= row[k] <= 1.0 for k in fracs),
              f"offsets: {row}")
    check(set(launches) == {(cin, cout, hw) for cin, cout, hw, _ in SITES},
          f"offsets: K1 launches by site {launches}")
    worst = max(sites, key=lambda r: r["frac_dy_clamped"])
    top = max(sites, key=lambda r: r["dy_max"])
    say(f"  offsets over {OH_IMAGES} images (K1's om, bf16, 512x512): "
        f"{len(sites)} sites; worst share of taps past R "
        f"{out['worst_frac_dy_clamped']:.6f} at {worst['site']} (R "
        f"{worst['max_dy']}); largest |dy| {top['dy_max']} at {top['site']} "
        f"({top['shape']}); K1 launches {dc.dcn_v2_fused.launches}; "
        f"{wall:.2f} s; {card}")
    return launches


def wire_bytes_per_image(cfg, wire: str) -> int:
    """The bytes one encoded training example carries to the device
    (``encode_example`` without its meta entries c and s): the image
    (float32, or uint8 and 6 float32 colour coefficients on the compact
    wire), the two heatmaps (float32, or float16 on the compact wire) and
    the float32 and int32 targets of ``max_objs`` objects."""
    res, out = cfg.model.input_res, cfg.model.output_res
    k, j = cfg.dataset.max_objs, cfg.model.num_joints
    compact = wire == "compact"
    image = res * res * 3 * (1 if compact else 4) + (6 * 4 if compact else 0)
    heatmaps = out * out * (1 + j) * (2 if compact else 4)
    # wh, hps, reg, ind, reg_mask, hps_mask, hp_offset, hp_ind, hp_mask
    targets = 4 * (2 * k + 2 * j * k + 2 * k + k + k + 2 * j * k + 2 * j * k
                   + j * k + j * k)
    return image + heatmaps + targets


def unfused_om_check(state_dict, card: str) -> None:
    """The forward with ``dcn_fused_om`` off against the fused one on
    EXPORT_BATCH frames: heads within TOL_UNFUSED, every row scoring >=
    test.vis_thresh on either side matched (``match_rows``)."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.data.synthetic import render_scene
    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.tools.ablate_step import model_cfg

    fused = Detector(model_cfg("pallas_full"), state_dict, device="cuda")
    unfused = Detector(model_cfg("pallas_full", fused_om=False), state_dict,
                       device="cuda")
    frames = [render_scene(np.random.default_rng(400 + i), 640, 480, 2)[0]
              for i in range(EXPORT_BATCH)]
    pre = [fused.pre_process(f) for f in frames]
    x = torch.cat([p[0] for p in pre]).float()
    x = (x / 255.0 - fused.mean) / fused.std
    with torch.inference_mode():
        heads = [det.model(x) for det in (unfused, fused)]
        rows = [det.process(x).cpu().numpy() for det in (unfused, fused)]
    err = head_rel_err(*heads)
    l2 = max(((a - heads[1][k]).norm() / heads[1][k].norm()).item()
             for k, a in heads[0].items())
    n_conf = unmatched = 0
    worst_px = worst_score = 0.0
    for i, (_, meta) in enumerate(pre):
        a, b = (fused.post_process(r[i:i + 1], meta)[1] for r in rows)
        n, u, px, ds = match_rows(a, b, fused.cfg.test.vis_thresh)
        n_conf += n
        unmatched += u
        worst_px, worst_score = max(worst_px, px), max(worst_score, ds)
    say(f"  unfused om (dcn_fused_om false: om conv in bf16, then K2) vs "
        f"fused (K1), {EXPORT_BATCH} frames: heads rel err {err:.3e}, "
        f"relative L2 {l2:.3e} (limits {TOL_UNFUSED}); {n_conf} rows "
        f"score >= {fused.cfg.test.vis_thresh} on either side, {unmatched} "
        f"unmatched, worst center {worst_px:.3f} px, worst score diff "
        f"{worst_score:.4f}; {card}")
    check(err <= TOL_UNFUSED[0] and l2 <= TOL_UNFUSED[1],
          f"unfused om: heads rel err {err}, relative L2 {l2}")
    check(n_conf >= EXPORT_BATCH, f"unfused om: only {n_conf} rows")
    check(unmatched == 0, f"unfused om: {unmatched} of {n_conf} rows "
          "without a match in the fused forward's")


def ablation_phase(state_dict, card: str) -> dict:
    """``tools/ablate_step`` at batch TRAIN_BATCH (every row's wall and
    busy ms finite and above 0, its launches per call as ABL_LAUNCHES)
    and ``tools/bench_input_pipeline`` (rates finite and above 0, each
    wire's bytes per image its tensors' arithmetic, the card's training
    rate); the unfused-om forward against the fused one.  Returns the K2
    and backward launches by site of the two tools' runs."""
    import math

    import torch

    from centerpose_tpu_torch.ops import dcn_cuda as dc
    from centerpose_tpu_torch.tools import ablate_step, bench_input_pipeline

    dc.reset_launch_counts()
    t0 = time.perf_counter()
    rows = ablate_step.run(TRAIN_BATCH, ABL_ITERS, str(NPZ), "cuda")
    t1 = time.perf_counter()
    res = bench_input_pipeline.run(ABL_IMAGES, ABL_SAMPLES, "cuda")
    torch.cuda.synchronize()
    say(f"  ablate_step {t1 - t0:.2f} s, bench_input_pipeline "
        f"{time.perf_counter() - t1:.2f} s")
    launches = {"dcn_v2": dict(dc.dcn_v2.launches_by_site),
                "dcn_v2_backward": dict(dc.dcn_v2_backward.launches_by_site)}
    say("  ablation " + json.dumps(rows))
    say("  input pipeline " + json.dumps(res))
    for name, want in ABL_LAUNCHES.items():
        for key in ("ms", "busy_ms"):
            v = rows[f"{name}_{key}"]
            check(math.isfinite(v) and v > 0, f"ablation {name}_{key}: {v}")
        got = rows[f"{name}_launches"]
        check((got["k1"], got["k2"], got["backward"]) == want,
              f"ablation {name}: launches per call {got}, not {want}")
    for name in ablate_step.DERIVED:
        check(all(math.isfinite(rows[f"{name}_{k}"])
                  for k in ("ms", "busy_ms")), f"ablation {name}")
    rates = [res["raw_render_img_s"], res["encode_only_native_img_s"],
             res["encode_only_python_img_s"],
             *(r["loader_img_s"] for r in res["loader_sweep"]),
             *(res[f"prefetch_{w}"]["prefetch_img_s"]
               for w in ("float32", "compact")),
             res["budget"]["card_train_img_s"]]
    check(all(math.isfinite(v) and v > 0 for v in rates),
          f"input pipeline rates {rates}")
    for wire in ("float32", "compact"):
        cfg = bench_input_pipeline.pipeline_cfg()
        want = wire_bytes_per_image(cfg, wire)
        got = res[f"prefetch_{wire}"]["bytes_per_image"]
        check(got == want, f"input pipeline {wire}: {got} bytes per image, "
              f"its tensors' arithmetic {want}")
    check(rows["card"] == card and res["card"] == card,
          f"ablation card {rows['card']}, {res['card']}")
    unfused_om_check(state_dict, card)
    b = res["budget"]
    say(f"  ablation at batch {TRAIN_BATCH} (ms wall / busy per call): "
        + "; ".join(f"{n} {rows[f'{n}_ms']:.3f} / {rows[f'{n}_busy_ms']:.3f}"
                    for n in (*ABL_LAUNCHES, *ablate_step.DERIVED))
        + f"; loader best {b['host_rate_img_s']:.2f} images/s against the "
        f"card's training {b['card_train_img_s']:.2f} (feeds "
        f"{b['host_feeds_n_cards']:.2f} cards); {card}")
    return launches


def only_kernels(card: str) -> int:
    """``--only kernels``: the build, the kernel, training kernel and
    determinism checks and the model check (no result line)."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    phase("build CUDA library", build)
    phase("kernel check", kernel_check)
    phase("training kernel check", train_kernel_check)
    phase("determinism check", determinism_check)
    state_dict = state_dict_from_npz(str(NPZ))
    phase("model check", lambda: model_check(state_dict))
    say(card)
    return 0


def only_ablation(card: str) -> int:
    """``--only ablation``: the build and the ablation phase alone (no
    result line)."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    phase("build CUDA library", build)
    state_dict = state_dict_from_npz(str(NPZ))
    phase("ablation", lambda: ablation_phase(state_dict, card))
    say(card)
    return 0


def only_offsets(card: str) -> int:
    """``--only offsets``: the build and the offsets phase alone (no
    result line)."""
    phase("build CUDA library", build)
    phase("offsets (main path)", lambda: offsets_phase(card))
    say(card)
    return 0


def only_spatial(card: str) -> int:
    """``--only spatial``: the build and the spatial-sharding main path
    alone (no result line)."""
    phase("build CUDA library", build)
    phase("spatial sharding (main path)", lambda: spatial_phase(card))
    say(card)
    return 0


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


def only_serving(card: str) -> int:
    """``--only serving``: the build and the serving main path alone (no
    result line)."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    phase("build CUDA library", build)
    state_dict = state_dict_from_npz(str(NPZ))
    phase("serving (main path)", lambda: serving(state_dict))
    say(card)
    return 0


def only_data_parallel(card: str) -> int:
    """``--only data-parallel``: the build and the data-parallel main path
    alone (no result line)."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    phase("build CUDA library", build)
    state_dict = state_dict_from_npz(str(NPZ))
    phase("data-parallel training (main path)",
          lambda: data_parallel(state_dict, card))
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
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of the data-parallel phase
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        dp_rank(int(args["--dp-rank"]), int(args["--dp-world"]),
                args["--dp-init"], args["--dp-out"])
        return 0
    if sys.argv[1:2] == ["--sp-rank"]:  # a rank of the spatial phase
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        sp_rank(int(args["--sp-rank"]), int(args["--sp-world"]),
                args["--sp-init"], args["--sp-out"])
        return 0
    t_all = time.perf_counter()

    card = phase("card", card_line)
    say(f"  {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--only", "training"]:
        return only_training(card)
    if sys.argv[1:] == ["--only", "serving"]:
        return only_serving(card)
    if sys.argv[1:] == ["--only", "data-parallel"]:
        return only_data_parallel(card)
    if sys.argv[1:] == ["--only", "spatial"]:
        return only_spatial(card)
    if sys.argv[1:] == ["--only", "offsets"]:
        return only_offsets(card)
    if sys.argv[1:] == ["--only", "ablation"]:
        return only_ablation(card)
    if sys.argv[1:] == ["--only", "kernels"]:
        return only_kernels(card)
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
    t_new = time.perf_counter()
    export_launches, export_k2 = phase(
        "export (main path)", lambda: export_phase(state_dict, card))
    t_new = time.perf_counter() - t_new
    train_launches, trainer, fixed = phase("training (main path)",
                                           lambda: training(state_dict))
    phase("training trace", lambda: train_trace(trainer, fixed))
    del trainer, fixed
    ds = phase("evaluation (main path)", lambda: evaluation(state_dict, card))
    phase("backbones (serving, main path)", lambda: backbones(ds, card))
    del ds
    phase("training CLI (main path)", lambda: training_cli(card))
    dp_launches = phase("data-parallel training (main path)",
                        lambda: data_parallel(state_dict, card))
    phase("backbones (training, main path)", lambda: backbone_training(card))
    t0 = time.perf_counter()
    phase("bench suite", lambda: bench_phase(card))
    t_new += time.perf_counter() - t0
    say(f"  export and bench suite phases: {t_new:.2f} s together")
    sp_launches = phase("spatial sharding (main path)",
                        lambda: spatial_phase(card))
    oh_launches = phase("offsets (main path)", lambda: offsets_phase(card))
    abl_launches = phase("ablation", lambda: ablation_phase(state_dict, card))
    for site, entry in entries.items():
        sp_site = site[:3]  # (Cin, Cout, W): a shard's rows are fewer
        check(launches.get(site, 0) > 0 and demo_launches.get(site, 0) > 0
              and export_launches.get(site, 0) > 0
              and sp_launches.get(sp_site, 0) > 0
              and oh_launches.get(sp_site, 0) > 0,
              f"K1 never launched at site {site}")
        entry["launches"] = (launches[site] + demo_launches[site]
                             + export_launches[site] + sp_launches[sp_site]
                             + oh_launches[sp_site])
    # K2's launches at the 512x512 sites: the training and data-parallel
    # main paths, the xla export, the ablation's unfused-om forward and
    # training rows and the input pipeline's training rate; the backward's:
    # the training and data-parallel paths and the ablation's
    k2_more = {"dcn_v2": export_k2, "dcn_v2_backward": {}}
    for (kernel, site), entry in train_entries.items():
        check(train_launches[kernel].get(site, 0) > 0
              and dp_launches[kernel].get(site, 0) > 0
              and abl_launches[kernel].get(site, 0) > 0
              and (kernel != "dcn_v2" or export_k2.get(site, 0) > 0),
              f"{kernel} never launched at site {site}")
        entry["launches"] = (train_launches[kernel][site]
                             + dp_launches[kernel][site]
                             + abl_launches[kernel][site]
                             + k2_more[kernel].get(site, 0))
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
