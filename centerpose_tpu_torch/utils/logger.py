"""Text and scalar logging, counterpart of ``centerpose_tpu/utils/logger.py``.

Writes the full config once (``opt_<time>.txt``), timestamped ``log.txt``
lines per epoch and the scalar history as JSON lines (``scalars.jsonl``);
TensorBoard event files too where ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional


class AverageMeter:
    """Running mean of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Logger:
    """Logs of one run under ``log_dir`` (default
    ``<cfg.output_dir>/<cfg.exp_id>``)."""

    def __init__(self, cfg, log_dir: Optional[str] = None):
        self.log_dir = log_dir or os.path.join(cfg.output_dir, cfg.exp_id)
        os.makedirs(self.log_dir, exist_ok=True)
        ts = time.strftime("%Y-%m-%d-%H-%M")
        with open(os.path.join(self.log_dir, f"opt_{ts}.txt"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        self._log = open(os.path.join(self.log_dir, "log.txt"), "a")
        self._scalars = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:  # optional
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.log_dir)
        except Exception:
            pass

    def write(self, txt: str):
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        self._log.write(f"{ts} | {txt}\n")
        self._log.flush()
        print(txt, flush=True)

    def scalar_summary(self, tag: str, value: float, step: int):
        self._scalars.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._scalars.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def log_stats(self, prefix: str, epoch: int, step: int,
                  stats: Dict[str, float]):
        parts = " ".join(f"{k} {float(v):.5f}" for k, v in stats.items())
        self.write(f"{prefix} epoch {epoch} | {parts}")
        for k, v in stats.items():
            self.scalar_summary(f"{prefix}/{k}", float(v), step)

    def close(self):
        self._log.close()
        self._scalars.close()
        if self._tb is not None:
            self._tb.close()
