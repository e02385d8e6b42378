"""Profiling hooks: named spans at the port's layer boundaries, and a
trace window over training steps.

``span(name)`` marks a region of the host's work.  While a
``torch.profiler`` session records, it is ``torch.profiler.
record_function(name)``: the span lands in the same profile as the
kernels and copies it launched, on the same clock, so each idle gap of
the device's timeline can be matched to the span the host was in.
Otherwise (no session, or while ``torch.compile`` or ``torch.export``
traces the code) it is one shared no-op context: no dispatcher call and
nothing in a captured graph, about a third of a microsecond a use.

The spans, nested in the order given:

* ``serve.batch`` (``Detector.run_batch``) holding ``serve.upload`` (the
  frames' host-to-device copy), ``serve.model`` and ``serve.decode``
  (``ServingNet.forward``: normalisation, flip and the model; sigmoids,
  flip merge and ``multi_pose_decode``) and ``serve.readback`` (the wait
  for the device and the rows' device-to-host copy);
* ``train.step`` (``Trainer.train_step``) holding ``train.upload``
  (``batch_to_device`` and ``unpack_batch``), ``train.forward`` (the model
  and the loss), ``train.backward`` (with DDP's all-reduce) and
  ``train.optimizer`` (schedule, update and ``zero_grad``);
* ``data.wait`` (``data/loader.prefetch_to_device``): the consumer
  blocked on the producer's next batch.

The DCN operators need no span: the dispatcher records
``centerpose::dcn_v2_fused`` (K1) and ``centerpose::dcn_v2`` (K2) around
each call.

``step_trace_window`` records such a profile over a window of training
steps and writes it as a Chrome trace (``trace_<pid>_<n>.json``, viewable
in Perfetto or chrome://tracing) into a log directory::

    with step_trace_window(logdir, start=10, stop=15) as tick:
        for step, batch in enumerate(batches):
            tick(step)          # starts/stops the trace at the window edges
            trainer.train_step(batch)
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import ContextManager, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_TRACE_ID = itertools.count()
_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """``record_function(name)`` while a profiler session records (and no
    compiler traces), else a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled \
            or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)


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
