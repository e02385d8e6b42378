"""Training CLI, counterpart of ``tools/train.py``.

    python -m centerpose_tpu_torch.tools.train [--synthetic [--hard] \
        [--synthetic-size N]] [--cfg FILE | --defaults] [--max-steps N] \
        [--device cpu] [--profile-dir DIR --profile-steps START:STOP] \
        [KEY VALUE ...]

Without ``--cfg`` the config is the flagship's (dla_34 @512, bfloat16,
``pallas_full``), built in code; ``--defaults`` starts from the config
defaults instead (float32, ``xla``, ``head_conv`` 64), as the reference's
``load_config(None, opts)`` does, e.g. ``--defaults model.name res_18``
trains any factory backbone at the yaml's settings without PyYAML;
``KEY VALUE`` pairs override it (e.g. ``train.batch_size 8 train.epochs 2
model.input_res 64``).  As the reference: with ``--synthetic`` train on
the seed-1 synthetic split and validate on seed 2; without it train on
``COCOHP(cfg, "train")`` and validate on ``"val"``, the COCO 2017
keypoint files under ``dataset.root`` (``data/coco.py``; images decoded
with cv2).  Log each epoch's loss stats (read at its first step and every
20th), images/s and the time blocked on the input pipeline
(``data_wait_s``, ``data_wait_frac``); save ``model_last`` (and
``model_<epoch>`` under ``train.save_all``) with its ``.meta.json``; every
``train.val_intervals`` epochs compute the val loss and the keypoint AP of
the current weights (``eval/harness.evaluate_detector`` on up to
``train.val_ap_limit`` images) and save ``model_best`` on a better AP;
``train.resume 1`` resumes from ``model_last``.  Logs and checkpoints go
to ``<output_dir>/<exp_id>``, where an ``output_dir`` of ``output`` (the
default, the JAX package's) becomes ``port_output``: by default
``port_output/default``.

Not ported: ``--multihost`` (data-parallel training, ROADMAP queue 1,
item 7).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from centerpose_tpu_torch.data.coco import COCOHP
from centerpose_tpu_torch.data.loader import DataLoader, prefetch_to_device
from centerpose_tpu_torch.data.synthetic import (SyntheticEvalDataset,
                                                 SyntheticPoseDataset)
from centerpose_tpu_torch.eval.harness import evaluate_detector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools.evaluate import (device_name, no_tf32,
                                                 run_config, run_dir)
from centerpose_tpu_torch.train.checkpoints import (ckpt_meta,
                                                    load_checkpoint,
                                                    restore_state,
                                                    save_checkpoint, to_host,
                                                    wait_for_saves)
from centerpose_tpu_torch.train.trainer import Trainer
from centerpose_tpu_torch.utils.logger import AverageMeter, Logger
from centerpose_tpu_torch.utils.platform import resolve_device
from centerpose_tpu_torch.utils.profiling import step_trace_window


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch training")
    p.add_argument("--cfg", type=str, default=None,
                   help="experiment yaml (default: the flagship, in code)")
    p.add_argument("--defaults", action="store_true",
                   help="without --cfg: start from the config defaults, "
                        "not the flagship")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (else the COCO files "
                        "under dataset.root)")
    p.add_argument("--synthetic-size", type=int, default=256)
    p.add_argument("--hard", action="store_true",
                   help="hard synthetic distribution (crowding, occlusion, "
                        "small persons)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process data-parallel training (not ported)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="optional hard cap on the steps of this run")
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a torch.profiler trace into this directory")
    p.add_argument("--profile-steps", type=str, default="10:15",
                   help="start:stop step window for --profile-dir traces")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", nargs="*", help="KEY VALUE config override pairs")
    return p.parse_args(argv)


def _train_epoch(trainer, batches, tick, steps_before: int,
                 max_steps: int):
    """The steps of one epoch over ``batches`` (device batches); returns
    (the epoch's stats, steps run, the loss of its first step).  Loss stats
    are read back (a sync) at the epoch's first step and every 20th."""
    meters: Dict[str, AverageMeter] = {}
    first_loss = None
    n_seen = steps = 0
    data_wait = 0.0  # time blocked on the input pipeline
    t0 = time.perf_counter()
    while True:
        t_w = time.perf_counter()
        b = next(batches, None)
        data_wait += time.perf_counter() - t_w
        if b is None:
            break
        tick(steps_before + steps)
        stats = trainer.train_step(b)
        steps += 1
        n_seen += len(b["input"])
        if steps == 1 or (steps_before + steps) % 20 == 0:
            host = {k: float(v) for k, v in stats.items()}
            first_loss = host["loss"] if first_loss is None else first_loss
            for k, v in host.items():
                meters.setdefault(k, AverageMeter()).update(v)
        if max_steps and steps_before + steps >= max_steps:
            break
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    dt = max(time.perf_counter() - t0, 1e-9)
    return ({**{k: m.avg for k, m in meters.items()},
             "img_per_s": n_seen / dt, "data_wait_s": data_wait,
             "data_wait_frac": data_wait / dt}, steps, first_loss)


def _val_loss(trainer, val_ds, cfg, device) -> Dict[str, float]:
    """The mean loss stats of ``eval_step`` over the val split."""
    loader = DataLoader(val_ds, cfg, batch_size=cfg.train.batch_size,
                        is_train=False, num_workers=0, seed=0)
    meters: Dict[str, AverageMeter] = {}
    for b in prefetch_to_device(loader.epoch(0), device):
        for k, v in trainer.eval_step(b).items():
            meters.setdefault(k, AverageMeter()).update(float(v))
    return {k: m.avg for k, m in meters.items()}


def main(argv=None) -> Dict:
    """Train; returns a summary for callers: the ``trainer``, ``log_dir``,
    ``start_epoch``, the per-epoch ``epochs`` stats, ``first_loss`` (the
    loss of this run's first step) and, after a resume, ``restored`` (a
    host copy of the state as restored)."""
    args = parse_args(argv)
    if args.multihost:
        raise SystemExit("--multihost is not ported: data-parallel training "
                         "is ROADMAP queue 1, item 7")
    no_tf32()
    cfg = run_config(args.cfg, args.opts, args.defaults)
    device = resolve_device(args.device)
    if args.synthetic:
        train_ds = SyntheticPoseDataset(args.synthetic_size, seed=1,
                                        hard=args.hard)
        val_n = max(32, args.synthetic_size // 8)
        val_ds = SyntheticPoseDataset(val_n, seed=2, hard=args.hard)
        ap_dataset = SyntheticEvalDataset(val_n, seed=2, hard=args.hard)
    else:
        train_ds = COCOHP(cfg, "train")
        val_ds = ap_dataset = COCOHP(cfg, "val")  # AP on image paths
    logger = Logger(cfg, run_dir(cfg))
    logger.write(f"device: {device_name(str(device))}")
    logger.write(f"train {len(train_ds)} images, val {len(val_ds)} images")

    train_loader = DataLoader(train_ds, cfg, batch_size=cfg.train.batch_size,
                              is_train=True,
                              num_workers=cfg.train.num_workers,
                              seed=cfg.train.seed)
    steps_per_epoch = max(1, train_loader.steps_per_epoch())
    trainer = Trainer(cfg, device=device, steps_per_epoch=steps_per_epoch)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.write(f"model {cfg.model.name}: {n_params / 1e6:.2f}M params")

    start_epoch = 0
    restored = None
    last_path = os.path.join(logger.log_dir, "model_last")
    if cfg.train.resume and os.path.exists(last_path):
        payload = load_checkpoint(last_path)
        restore_state(trainer, payload)
        start_epoch = int(payload["epoch"])
        restored = to_host(trainer.state())
        logger.write(f"resumed from {last_path} at epoch {start_epoch}")

    # the AP pass's detector has its own model: the trainer's float32
    # master weights are copied into it (cast to the compute dtype) before
    # each pass and never cast in place
    ap_detector = Detector(cfg, device=device)

    def run_ap_eval() -> Dict[str, float]:
        ap_detector.model.load_state_dict(trainer.model.state_dict())
        limit = cfg.train.val_ap_limit

        def limited():
            for k, item in enumerate(ap_dataset.items()):
                if limit and k >= limit:
                    return
                yield item

        results, _, wall = evaluate_detector(ap_detector, limited(), workers=2)
        # score only the evaluated images: under val_ap_limit the gate AP
        # is the AP of that subset
        stats = ap_dataset.run_eval(results, img_ids=list(results))
        stats["eval_wall_s"] = wall
        return stats

    if cfg.debug > 0:
        logger.write("debug rendering is not ported (cfg.debug ignored)")
    prof_start, prof_stop = (int(v) for v in args.profile_steps.split(":"))
    best_metric = -float("inf")
    total_steps = 0
    first_loss: Optional[float] = None
    epochs: List[Dict[str, float]] = []
    meta = ckpt_meta(cfg)
    try:
        window = step_trace_window(args.profile_dir, prof_start, prof_stop)
        with window as tick:
            for epoch in range(start_epoch + 1, cfg.train.epochs + 1):
                stats, steps, loss = _train_epoch(
                    trainer, prefetch_to_device(train_loader.epoch(epoch),
                                                device),
                    tick, total_steps, args.max_steps)
                total_steps += steps
                first_loss = loss if first_loss is None else first_loss
                logger.log_stats("train", epoch, trainer.step, stats)
                epochs.append({"epoch": epoch, **stats})
                save_checkpoint(last_path, trainer, epoch, meta=meta)
                if cfg.train.save_all:
                    save_checkpoint(os.path.join(logger.log_dir,
                                                 f"model_{epoch}"),
                                    trainer, epoch, meta=meta)
                if (cfg.train.val_intervals > 0
                        and epoch % cfg.train.val_intervals == 0):
                    logger.log_stats("val", epoch, trainer.step,
                                     _val_loss(trainer, val_ds, cfg, device))
                    ap_stats = run_ap_eval()
                    logger.log_stats("val_ap", epoch, trainer.step, ap_stats)
                    metric = epochs[-1]["AP"] = ap_stats.get("AP", -1.0)
                    if metric > best_metric:
                        best_metric = metric
                        save_checkpoint(os.path.join(logger.log_dir,
                                                     "model_best"),
                                        trainer, epoch, meta=meta)
                        logger.write(f"new best (val AP {metric:.4f}) at "
                                     f"epoch {epoch}")
                if args.max_steps and total_steps >= args.max_steps:
                    logger.write(f"hit --max-steps={args.max_steps}, stopping")
                    break
    finally:
        train_loader.close()
    wait_for_saves()  # the last checkpoint lands before the run ends
    logger.write("done")
    logger.close()
    return {"trainer": trainer, "log_dir": logger.log_dir,
            "start_epoch": start_epoch, "epochs": epochs,
            "first_loss": first_loss, "restored": restored}


if __name__ == "__main__":
    main()
