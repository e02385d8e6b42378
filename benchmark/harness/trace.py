"""A traced stretch of a run, reduced to plain numbers.

``record`` runs a callable under ``torch.profiler`` (host and device
activity) for a fixed number of items (batches or steps), ended by a
synchronisation, and keeps what the per-layer readers need: each device
event's (start, end, name) in microseconds, each host operator's, the
stretch's start and end and its item count.

``busy_us`` is the length of the union of the device events' intervals,
copied from the port's ``tools/ablate_step.busy_ms``: kernels and copies
count; user annotations, which span other events and gaps, do not.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple

Span = Tuple[float, float, str]


def busy_us(spans: Sequence[Span]) -> float:
    """The length of the union of the intervals of ``spans``, in us."""
    total, reach = 0.0, float("-inf")
    for start, end, _ in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


@dataclass
class Trace:
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)
    items: int = 0
    start_us: float = 0.0
    end_us: float = 0.0
    read_s: float = 0.0  # the time taken to read the profile

    @property
    def busy_s(self) -> float:
        return busy_us(self.device) / 1e6

    def kernel_us(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the events whose name ``match``es."""
        return sum(e - s for s, e, n in self.device if match(n))

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations by summed time: [[name, s], ...]."""
        acc = {}
        for s, e, name in self.device:
            acc[name] = acc.get(name, 0.0) + (e - s) / 1e6
        return [[k[:200], v] for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time inside the stretch, summed by what the
        host was doing at each gap's middle (the innermost host operator
        spanning it, or ``host idle``): the ``n`` largest, [[label, s]]."""
        gaps, reach = [], self.start_us
        for s, e, _ in sorted(self.device):
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if self.end_us > reach:
            gaps.append((reach, self.end_us))
        acc = {}
        for (a, b), label in zip(gaps, self._innermost([(a + b) / 2
                                                        for a, b in gaps])):
            acc[label] = acc.get(label, 0.0) + (b - a) / 1e6
        return [[k[:200], v] for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self, times: List[float]) -> List[str]:
        """For each of the ascending ``times``, the name of the innermost
        host operator spanning it (the one that started last), or ``host
        idle``: one sweep over the host events sorted by start, with the
        spans started so far in a heap by start, ended ones dropped."""
        host = sorted(self.host)
        heap: list = []
        out, j = [], 0
        for t in times:
            while j < len(host) and host[j][0] <= t:
                s, e, name = host[j]
                heapq.heappush(heap, (-s, e, name))
                j += 1
            while heap and heap[0][1] < t:
                heapq.heappop(heap)
            out.append(heap[0][2] if heap else "host idle")
        return out


def record(step: Callable[[int], object], items: int,
           sync: Callable[[], None], on_cpu: bool = False) -> Trace:
    """Run ``step(i)`` for i < ``items`` under the profiler and reduce the
    profile to a ``Trace``.  The stretch is ended by ``sync``.  ``on_cpu``
    (the tests' small runs, never a result line): the host's ``aten``
    operators stand in for the device's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    acts = [ProfilerActivity.CPU] + ([] if on_cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        with record_function("bench.stretch"):
            for i in range(items):
                step(i)
            sync()
    t_read = time.perf_counter()
    tr = Trace(items=items)
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type == DeviceType.CUDA or (
                on_cpu and ev.name.startswith("aten::")):
            if getattr(ev, "is_user_annotation", False) \
                    or ev.name.startswith(("Optimizer.", "bench.")):
                continue
            tr.device.append(span)
        elif ev.name == "bench.stretch":
            tr.start_us, tr.end_us = span[0], span[1]
        else:
            tr.host.append(span)
    if not tr.device:
        raise RuntimeError("the profiler recorded no device activity")
    tr.read_s = time.perf_counter() - t_read
    return tr
