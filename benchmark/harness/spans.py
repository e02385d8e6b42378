"""The program's spans in a traced stretch, against the device's idle time.

The port marks its layer boundaries with ``record_function`` spans
(``serve.*``, ``train.*``) and the dispatcher records each DCN operator
call (``centerpose::dcn_v2_fused``, ``centerpose::dcn_v2``); ``record``
keeps them among the host events of a ``Trace``, on the device events'
clock.  The readers of ``metrics/`` reduce them here:

* ``durations``: the host events of a name, clipped to the stretch;
* ``union``: the union of the host events of given names, clipped;
* ``idle``: the device's idle intervals, the complement of the union of
  the device events inside the stretch (the arithmetic of
  ``trace.busy_us``);
* ``overlap_us``: the length of the intersection of two unions.

All intervals are (start, end) in microseconds; a union is sorted and
disjoint.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def _clip(trace, start: float, end: float):
    s, e = max(start, trace.start_us), min(end, trace.end_us)
    return (s, e) if e > s else None


def durations(trace, name: str) -> List[float]:
    """The durations (us) of the host events named ``name``, each clipped
    to the stretch; those wholly outside it left out."""
    out = []
    for s, e, n in trace.host:
        if n == name:
            c = _clip(trace, s, e)
            if c is not None:
                out.append(c[1] - c[0])
    return out


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union(trace, names: Sequence[str]) -> List[Interval]:
    """The union of the host events named in ``names``, clipped to the
    stretch."""
    want = set(names)
    return merge(c for c in (_clip(trace, s, e) for s, e, n in trace.host
                             if n in want) if c is not None)


def idle(trace) -> List[Interval]:
    """The intervals of the stretch in which no device event ran."""
    out, reach = [], trace.start_us
    for s, e in merge((s, e) for s, e, _ in trace.device):
        if s > reach:
            out.append((reach, min(s, trace.end_us)))
        reach = max(reach, e)
        if reach >= trace.end_us:
            break
    if trace.end_us > reach:
        out.append((reach, trace.end_us))
    return out


def length_us(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def overlap_us(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The length of the intersection of two unions (sorted, disjoint)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stretch_us(trace) -> float:
    return trace.end_us - trace.start_us
