"""Ranks of the port's data-parallel and spatial-sharding tests
(tests/test_torch_parallel*.py, tests/test_torch_spatial*.py).

``run_ranks`` (``start_ranks``, ``wait_ranks``) starts ``world``
processes of this file, one rank each, on
the CPU with gloo and a ``file://`` rendezvous in the test's temporary
directory (no port to collide under xdist), each with its share of the
test worker's torch threads, and waits for them under a timeout: a
collective that one rank misses fails the test instead of hanging it.
Each rank runs one job and writes its results with ``torch.save``; a
world of 1 runs the job without a process group (the one-process
reference).

    python tests/_torch_dp.py JOB --rank R --world W --init URL --out PATH
        [--arg KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RANK_TIMEOUT_S = 240


def start_ranks(job: str, world: int, tmp_path, **kwargs):
    """Start ``job`` on ``world`` ranks (``kwargs`` reach it as strings);
    ``wait_ranks`` collects them."""
    from _torch_port import share_cores_among_workers

    threads = max(1, share_cores_among_workers() // world)
    tag = f"{job}_{world}_{abs(hash(tuple(sorted(kwargs.items()))))}"
    init = f"file://{tmp_path}/rdv_{tag}"
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]))
    outs = [tmp_path / f"{tag}_rank{r}.pt" for r in range(world)]
    args = [a for k, v in kwargs.items() for a in ("--arg", f"{k}={v}")]
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, "--rank", str(r), "--world",
         str(world), "--init", init, "--out", str(outs[r]), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return job, procs, outs


def wait_ranks(handle, timeout: float = RANK_TIMEOUT_S) -> list:
    """Each rank's results of a ``start_ranks`` (rank order), once all
    have ended; a rank still running after ``timeout`` seconds is killed
    and fails the test, as does a rank that failed."""
    import torch

    job, procs, outs = handle
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n" + "\n".join(
            log[-4000:] for log in logs)
    return [torch.load(o, weights_only=False) for o in outs]


def run_ranks(job: str, world: int, tmp_path, **kwargs) -> list:
    """``start_ranks`` then ``wait_ranks``."""
    return wait_ranks(start_ranks(job, world, tmp_path, **kwargs))


# ---------------------------------------------------------------- jobs


def _bn(rank, world, group, a):
    """Train-mode BatchNorm on this rank's half of one [8, C, 16, 16]
    batch and cotangent (``bn_case``), float32 and bfloat16: the output,
    the running statistics, the input gradient and the scale and bias
    gradients."""
    import torch

    from _torch_dp import bn_case
    from centerpose_tpu_torch.models.common import BatchNorm2d

    out = {}
    for dtype in ("float32", "bfloat16"):
        x, ct, scale, bias, ra_mean, ra_var = bn_case()
        n = len(x) // world
        sl = slice(rank * n, (rank + 1) * n)
        m = BatchNorm2d(x.shape[1]).train()
        m.process_group = group
        with torch.no_grad():
            for t, v in ((m.weight, scale), (m.bias, bias),
                         (m.running_mean, ra_mean), (m.running_var, ra_var)):
                t.copy_(torch.from_numpy(v))
        tdt = getattr(torch, dtype)
        xt = (torch.from_numpy(x[sl]).to(tdt)
              .contiguous(memory_format=torch.channels_last).requires_grad_())
        y = m(xt)
        y.backward(torch.from_numpy(ct[sl]).to(tdt))
        out[dtype] = {"y": y.detach().float(), "gx": xt.grad.float(),
                      "gw": m.weight.grad.clone(), "gb": m.bias.grad.clone(),
                      "mean": m.running_mean.clone(),
                      "var": m.running_var.clone()}
    return out


def bn_case(seed: int = 11, c: int = 16):
    """x [8, c, 16, 16] (mean 0.5, channels on different scales), a
    cotangent, scale, bias and running statistics, float32 numpy."""
    import numpy as np

    r = np.random.default_rng(seed)
    x = (r.normal(size=(8, c, 16, 16)) * r.uniform(0.5, 3.0, (1, c, 1, 1))
         + 0.5).astype(np.float32)
    ct = r.normal(size=x.shape).astype(np.float32)
    return (x, ct, r.uniform(0.5, 1.5, c).astype(np.float32),
            r.normal(size=c).astype(np.float32),
            r.normal(size=c).astype(np.float32),
            r.uniform(0.5, 2.0, c).astype(np.float32))


def _loss(rank, world, group, a):
    """``multi_pose_loss`` on this rank's shard of the targets and of each
    variant's head outputs (``out_<variant>_<head>``) in ``a['case']`` (an
    .npz): with the group (global normalizers) and without (this rank's
    own), the loss, the stats and the gradient of the loss at the
    outputs, by variant."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.config import default_config, update_config
    from centerpose_tpu_torch.losses import multi_pose_loss

    cfg = update_config(default_config(), {"model": {
        "input_res": 64, "output_res": 16}, "dataset": {"max_objs": 4}})
    with np.load(a["case"]) as f:
        data = {k: f[k] for k in f.files}
    n = len(data["hm"]) // world
    sl = slice(rank * n, (rank + 1) * n)
    batch = {k: torch.from_numpy(v[sl]) for k, v in data.items()
             if not k.startswith("out_")}
    variants = {k.split("_")[1] for k in data if k.startswith("out_")}
    out = {}
    for variant in sorted(variants):
        prefix = f"out_{variant}_"
        out[variant] = {}
        for mode, g in (("global", group), ("local", None)):
            outputs = {k[len(prefix):]: torch.from_numpy(v[sl])
                       .requires_grad_() for k, v in data.items()
                       if k.startswith(prefix)}
            loss, stats = multi_pose_loss(outputs, batch, cfg, g)
            loss.backward()
            out[variant][mode] = {
                "loss": float(loss),
                "stats": {k: float(v) for k, v in stats.items()},
                "grads": {k: v.grad for k, v in outputs.items()}}
    return out


def _step_cfg(name: str, global_batch: int, optimizer: str,
              grad_accum: int = 1):
    from centerpose_tpu_torch.config import default_config, update_config

    return update_config(default_config(), {
        "model": {"name": name, "input_res": 64, "output_res": 16},
        "dataset": {"max_objs": 4},
        "train": {"batch_size": global_batch, "seed": 7,
                  "optimizer": optimizer, "lr": 0.01,
                  "grad_accum": grad_accum}})


def _float64_trainer() -> None:
    """Make every ``Trainer`` of this process compute in float64: the
    model cast before the optimizer and DDP see the parameters, the heads'
    outputs and the loss (``Tensor.float`` leaves a float64 tensor as it
    is) and the DCN sites' plain version (``ops/dcn.py``, which computes
    in float32, sees float64 in its place).  The f32 rounding of these
    seeded steps, which the BatchNorms amplify into gradients ~1e-2 apart
    (``test_two_ranks_match_one_process``), goes."""
    import torch

    from centerpose_tpu_torch.models import common
    from centerpose_tpu_torch.ops import dcn
    from centerpose_tpu_torch.train import trainer

    class Torch64:
        float32 = torch.float64

        def __getattr__(self, name):
            return getattr(torch, name)

    trainer.model_dtype = lambda cfg: torch.float64
    trainer.set_compute_dtype = lambda m, dt: common.set_compute_dtype(
        m.double(), dt)
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_float(t, *a, **k))
    dcn.torch = Torch64()


def _step(rank, world, group, a):
    """``tests/_mp_worker.py``'s run in the port: this rank's shard of the
    seeded synthetic split (``a['images']`` images, global batch
    ``a['batch']``) through the loader and the Trainer (data-parallel over
    the group) for ``a['steps']`` steps (0: the whole epoch), an update
    every ``a['accum']``; the losses, the updates, the state after them
    and the optimizer's state layout."""
    from centerpose_tpu_torch.data.loader import DataLoader
    from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
    from centerpose_tpu_torch.train.trainer import Trainer

    gb = int(a.get("batch", 8))
    cfg = _step_cfg(a["name"], gb, a.get("optimizer", "sgd"),
                    int(a.get("accum", 1)))
    if a.get("dtype") == "float64":
        _float64_trainer()
    loader = DataLoader(SyntheticPoseDataset(int(a.get("images", 16)),
                                             seed=1),
                        cfg, batch_size=gb // world, is_train=True,
                        num_workers=0, seed=cfg.train.seed, shard_id=rank,
                        num_shards=world)
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=2, group=group)
    steps = int(a.get("steps", 2))
    losses = []
    for i, batch in enumerate(loader.epoch(0)):
        if steps and i >= steps:
            break
        losses.append(float(trainer.train_step(batch)["loss"]))
    opt = trainer.optimizer.opt.state_dict()
    return {"losses": losses, "model": trainer.model.state_dict(),
            "updates": trainer.optimizer.updates,
            "n_params": len(trainer.optimizer.params),
            "opt_layout": {i: {k: tuple(v.shape) for k, v in st.items()}
                           for i, st in opt["state"].items()}}


def _ref_step(rank, world, group, a):
    """One Adam step of ``tests/_torch_train_step.py``'s case (its seeded
    variables and batch, saved by the test in ``a['case']``) on this rank's
    shard of the batch: the loss stats, the all-reduced gradients, the
    state after the update."""
    import torch

    from centerpose_tpu_torch.config import update_config
    from centerpose_tpu_torch.train.trainer import Trainer

    case = torch.load(a["case"], weights_only=False)
    cfg = update_config(case["cfg"], {"train": {
        "batch_size": len(case["batch"]["input"])}})
    n = len(case["batch"]["input"]) // world
    batch = {k: v[rank * n:(rank + 1) * n] for k, v in case["batch"].items()}
    trainer = Trainer(cfg, case["state_dict"], device="cpu", group=group)
    stats = {k: float(v) for k, v in trainer.backward(batch).items()}
    grads = {name: None if p.grad is None else p.grad.clone()
             for name, p in trainer.model.named_parameters()}
    assert trainer.optimizer.step()
    return {"stats": stats, "grads": grads,
            "model": trainer.model.state_dict()}


def _spatial_model(spec: dict):
    """The eval model of ``spec`` (``name``, ``res``, ``dcn_impl``,
    ``dtype``, optional ``head_conv``; weights: the state dict
    ``state_dict`` or, without one, the factory's init after
    ``torch.manual_seed(seed)``), channels_last, in its compute dtype."""
    import torch

    from centerpose_tpu_torch.config import default_config, update_config
    from centerpose_tpu_torch.models.common import (to_channels_last,
                                                    to_compute_dtype)
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.weights import load_state_dict

    res = spec["res"]
    model_ov = {"name": spec["name"], "input_res": res,
                "output_res": res // 4, "dcn_impl": spec.get("dcn_impl",
                                                             "xla")}
    if "head_conv" in spec:
        model_ov["head_conv"] = spec["head_conv"]
    cfg = update_config(default_config(), {"model": model_ov})
    torch.manual_seed(spec.get("seed", 0))
    model = create_model(cfg)
    if spec.get("state_dict") is not None:
        load_state_dict(model, spec["state_dict"])
    dtype = getattr(torch, spec.get("dtype", "float32"))
    return to_channels_last(to_compute_dtype(model, dtype)).eval()


def _spatial(rank, world, group, a):
    """Each model of ``a['case']`` (a ``torch.save``d list of
    ``_spatial_model`` specs, each with its input ``x`` [B, H, W, 3]) on a
    ``a['data']`` x ``a['spatial']`` mesh (``parallel/mesh.
    create_mesh_2d``, ``spatial_sharding``): the gathered heads, and on
    rank 0 the same model's one-process forward on the whole input, in
    this process (the same threads)."""
    import torch

    from centerpose_tpu_torch.parallel.mesh import (create_mesh_2d,
                                                    spatial_sharding)

    mesh = create_mesh_2d(int(a["data"]), int(a["spatial"]))
    sharding = spatial_sharding(mesh)
    out = []
    for spec in torch.load(a["case"], weights_only=False):
        model = _spatial_model(spec)
        x = spec["x"]
        with torch.no_grad():
            one = model(x) if rank == 0 else None
            out.append({"sharded": sharding.forward(model, x), "one": one})
    return out


def _spatial_edge(rank, world, group, a):
    """One DCN site (``models/dla.DCN``, eval, ``pallas_full``) on image
    rows over the ``world`` ranks, its offsets injected through the om
    conv's bias (weights zero: every pixel has the same taps): for each dy
    of ``a['dy']`` (comma-separated), dy and -dy in turn over the taps, so
    that the rows beside each shard boundary sample as far as the clamp
    lets them into the neighbours.  Each dy runs as it is and under two
    mutants: ``halo1`` cuts the halo to 1 row, ``local`` keys the site
    policy on the shard's height.  Returns {dy: {variant: the output of
    the whole image (gathered rows)}, and rank 0 adds ``one``: the
    one-process output}, with the heights the site policy was asked for."""
    import numpy as np
    import torch

    from centerpose_tpu_torch.models import dla
    from centerpose_tpu_torch.parallel import spatial

    b, c, h, w = (int(v) for v in a["shape"].split(","))
    r = np.random.default_rng(5)
    site = dla.DCN(c, c, "pallas_full").eval()
    x = torch.from_numpy(r.normal(size=(b, c, h, w)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        site.weight.copy_(torch.from_numpy(
            r.normal(size=site.weight.shape).astype(np.float32)))
        site.bias.copy_(torch.from_numpy(r.normal(size=c).astype(np.float32)))
        site.conv_offset_mask.weight.zero_()
    policy, halo, rows = dla.site_max_dy, dla.clamped_halo, spatial.global_rows
    seen = []

    def spy(*key):
        seen.append(key[0])
        return policy(*key)

    hl = h // world
    shards = spatial.RowShards(group, rank, world, (hl,) * world, w)
    out = {"policy_rows": seen}
    for dy in (float(v) for v in a["dy"].split(",")):
        omb = np.zeros(27, np.float32)
        omb[0:18:2] = [dy if k % 2 else -dy for k in range(9)]
        omb[1:18:2] = 0.25
        omb[18:] = 2.0
        with torch.no_grad():
            site.conv_offset_mask.bias.copy_(torch.from_numpy(omb))
        res = out[dy] = {}
        for variant in ("sharded", "halo1", "local"):
            dla.site_max_dy = spy if variant == "sharded" else policy
            if variant == "halo1":
                dla.clamped_halo = lambda max_dy: 1
            if variant == "local":
                spatial.global_rows = lambda t: t.shape[2]
            try:
                with torch.no_grad(), spatial.row_sharded(shards):
                    mine = site(x[:, :, rank * hl:(rank + 1) * hl])
            finally:
                dla.site_max_dy, dla.clamped_halo = policy, halo
                spatial.global_rows = rows
            res[variant] = torch.cat(list(spatial.all_gather_exact(
                mine.contiguous(), group, world, rank)), 2)
        if rank == 0:
            with torch.no_grad():
                res["one"] = site(x)
    return out


JOBS = {"bn": _bn, "loss": _loss, "step": _step, "ref_step": _ref_step,
        "spatial": _spatial, "spatial_edge": _spatial_edge}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("job", choices=sorted(JOBS))
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--arg", action="append", default=[])
    args = p.parse_args()
    a = dict(kv.split("=", 1) for kv in args.arg)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    sys.modules["torch.utils.tensorboard"] = None  # optional; slow import
    from centerpose_tpu_torch.parallel.mesh import init_distributed

    group = None
    if args.world > 1:
        init_distributed(args.init, args.world, args.rank, backend="gloo",
                         device="cpu", timeout=RANK_TIMEOUT_S / 2)
        group = dist.group.WORLD
    try:
        torch.save(JOBS[args.job](args.rank, args.world, group, a), args.out)
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
