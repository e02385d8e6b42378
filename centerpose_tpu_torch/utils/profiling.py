"""Profiling hooks, counterpart of ``centerpose_tpu/utils/profiling.py``.

``trace`` and ``step_trace_window`` record a ``torch.profiler`` trace (host
and, on the card, CUDA activity) and write it as a Chrome trace
(``trace_<n>.json``, viewable in Perfetto or chrome://tracing) into the
log directory; ``StageTimer`` accumulates named wall-clock stages.

Usage::

    with step_trace_window(logdir, start=10, stop=15) as tick:
        for step, batch in enumerate(batches):
            tick(step)          # starts/stops the trace at the window edges
            trainer.train_step(batch)

    with trace("/tmp/profile"):
        run_inference()
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterator, Optional

import torch

_TRACE_ID = itertools.count()


def _start(logdir: str) -> torch.profiler.profile:
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, logdir: str) -> str:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACE_ID)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Trace the enclosed region into ``logdir``."""
    prof = _start(logdir)
    try:
        yield
    finally:
        _stop(prof, logdir)


@contextlib.contextmanager
def step_trace_window(logdir: Optional[str], start: int, stop: int):
    """Yield a ``tick(step)`` callable that traces steps in [start, stop).

    No-op when ``logdir`` is falsy.  The caller calls ``tick(step)`` at the
    top of every step; the trace starts at ``step == start`` and stops at
    ``step >= stop`` (or when the context exits, if the loop ends first)."""
    if not logdir:
        yield lambda step: None
        return
    active = [None]

    def tick(step: int) -> None:
        if step == start and active[0] is None:
            active[0] = _start(logdir)
        elif step >= stop and active[0] is not None:
            _stop(active[0], logdir)
            active[0] = None

    try:
        yield tick
    finally:
        if active[0] is not None:
            _stop(active[0], logdir)


class StageTimer:
    """Accumulating named-stage wall timer.  ``lap(name, block_on)`` waits
    for the device first when ``block_on`` is a CUDA tensor, so the stage's
    time covers its device work."""

    def __init__(self):
        self.times = {}
        self._t = None

    def start(self) -> None:
        self._t = time.perf_counter()

    def lap(self, name: str, block_on=None) -> float:
        if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        now = time.perf_counter()
        dt = now - self._t
        self.times[name] = self.times.get(name, 0.0) + dt
        self._t = now
        return dt
