"""Spatial sharding of the serving forward: image rows over a process group.

Counterpart of what GSPMD does under ``centerpose_tpu/parallel/mesh.py:
spatial_sharding``: the reference shards ``[B, H, W, C]`` arrays with the
rows over a ``spatial`` mesh axis and XLA inserts the halo exchange of every
conv window.  In PyTorch nothing inserts them, so each op of the models that
reads a window of rows goes through this module while a ``RowShards`` is
active (``row_sharded``); with none active the ops are the plain calls,
unchanged.

* **The row arithmetic** (``Window``, ``window_rows``): for an op with
  kernel k, stride s, dilation d and padding (top, bottom), plain or
  transposed, the input rows an output shard reads, and where the shard's
  rows begin in the op's output on those rows (run with no row padding).
  Pure functions of integers.
* **The exchange** (``halo``): a shard's rows with ``top`` rows above and
  ``bottom`` below, taken from the neighbours over as many shards as the
  halo spans, and ``fill`` (zero, or ``-inf`` for a max pool) past the
  image's global top and bottom.  The neighbours' edge rows move by one
  ``all_reduce`` (sum) of a zero buffer in which each rank writes its own
  rows, seen as bytes: a sum with zeros is exact for any dtype, and both
  backends take ``all_reduce`` on CUDA tensors (NCCL refuses two ranks on
  one card, and gloo takes no CUDA tensor in ``send``/``recv`` or
  ``all_gather``; its ``all_reduce`` stages them through the host).
* **The ops** (``window``, ``mean_hw``): a windowed op on its exchanged rows,
  and the mean over H and W as an all-reduced sum.

Splits must be even: H divisible by the shard count times the model's total
stride (32), so that every shard of every level has the same height and
every rank exchanges the same rows; another split raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RowShards:
    """This rank's place in the image rows: shard ``index`` of ``count``
    (top to bottom), the others reached over ``group`` (None for one
    shard)."""

    group: object
    index: int
    count: int


# The RowShards of the forward running now, innermost last.  One per
# process, as a rank runs one sharded forward at a time; a list that
# torch.compile and torch.export trace through (reads only, outside one).
_ACTIVE: list = []


@contextlib.contextmanager
def row_sharded(shards: Optional[RowShards]):
    """Run the models' windowed ops inside on row shards (None: as they
    are)."""
    _ACTIVE.append(shards if shards is not None and shards.count > 1
                   else None)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active() -> Optional[RowShards]:
    """The row shards of the forward running now; None outside one."""
    return _ACTIVE[-1] if _ACTIVE else None


def global_rows(h: int) -> int:
    """The image-wide height of a level whose shards hold ``h`` rows."""
    sh = active()
    return h if sh is None else h * sh.count


# ---------------------------------------------------------------- rows


class Window(NamedTuple):
    """An op's window along the rows.  ``pad``: rows of padding (top,
    bottom) of a plain op; for a transposed one torch's ``padding`` p,
    symmetric, and ``output_padding``."""

    kernel: int
    stride: int = 1
    dilation: int = 1
    pad: Tuple[int, int] = (0, 0)
    transposed: bool = False
    output_padding: int = 0

    @property
    def span(self) -> int:
        return self.dilation * (self.kernel - 1) + 1


def out_rows(win: Window, h: int) -> int:
    """The op's output height on ``h`` input rows."""
    if win.transposed:
        return ((h - 1) * win.stride - 2 * win.pad[0] + win.span
                + win.output_padding)
    return (h + sum(win.pad) - win.span) // win.stride + 1


def window_rows(win: Window, lo: int, hi: int) -> Tuple[int, int, int]:
    """(first, end, offset): output rows [lo, hi) read the input rows
    [first, end), and in the op's output on those rows (no row padding)
    row lo is row ``offset``.  Rows before 0 or past the input's end stand
    for the padding (or, transposed, for rows that add nothing)."""
    s = win.stride
    if not win.transposed:
        first = lo * s - win.pad[0]
        return first, (hi - 1) * s - win.pad[0] + win.span, 0
    # transposed: output row o gets input row i where o + p = i*s + t*d
    p = win.pad[0]
    first = -(-(lo + p - (win.span - 1)) // s)
    end = (hi - 1 + p) // s + 1
    return first, end, lo + p - first * s


def shard_halo(win: Window, h: int, index: int, count: int
               ) -> Tuple[int, int, int, int]:
    """(top, bottom, offset, rows out) of shard ``index`` of ``count``, each
    ``h`` rows: the rows above and below the shard its output shard reads
    (negative: that many of its own it does not read), where its output
    begins in the op's output on them, and its output rows.  Raises where
    the output does not split evenly, or the halo differs between shards
    (the exchange moves the same rows for every rank)."""
    total = out_rows(win, h * count)
    if total % count:
        raise ValueError(f"{total} output rows of {win} do not split over "
                         f"{count} shards: the image height must be "
                         f"divisible by {count} times the model's stride")
    ho = total // count

    def at(i):
        first, end, offset = window_rows(win, i * ho, (i + 1) * ho)
        return i * h - first, end - (i + 1) * h, offset

    top, bottom, offset = at(index)
    if at(0)[:2] != (top, bottom):
        raise ValueError(f"{win} on {count} shards of {h} rows: uneven "
                         f"halo {at(0)[:2]} against {(top, bottom)}")
    return top, bottom, offset, ho


# ---------------------------------------------------------------- exchange


def all_gather_exact(t: torch.Tensor, group, count: int,
                     index: int) -> torch.Tensor:
    """[count, *t.shape]: every rank's ``t`` (same shape and dtype on each),
    gathered bit for bit by one ``all_reduce`` of a zero buffer in which
    rank ``index`` writes its own, summed as bytes."""
    buf = t.new_zeros((count, *t.shape))
    buf[index].copy_(t)
    dist.all_reduce(buf.view(-1).view(torch.uint8), op=dist.ReduceOp.SUM,
                    group=group)
    return buf


def _fill_rows(x: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    b, c, _, w = x.shape
    return x.new_full((b, c, n, w), fill)


def halo(x: torch.Tensor, top: int, bottom: int,
         fill: float = 0.0) -> torch.Tensor:
    """This shard's rows of the NCHW ``x`` with ``top`` rows above and
    ``bottom`` below (a negative count drops that many of its own), the
    same counts on every rank.  Rows past the image's top or bottom are
    ``fill``; the others come from the shards above and below, as many as
    the halo spans.  Inside ``row_sharded``: every rank of the group calls
    it with the same counts and shapes."""
    sh = active()
    n, i = sh.count, sh.index
    h = x.shape[2]
    up, down = max(top, 0), max(bottom, 0)
    ku, kd = min(up, h), min(down, h)  # rows each shard hands over
    pieces = None
    if ku + kd:
        edge = torch.cat([x[:, :, h - ku:], x[:, :, :kd]], 2)
        pieces = all_gather_exact(edge, sh.group, n, i)
    parts = []
    if up:
        m = -(-up // h)
        parts.append(torch.cat(
            [_fill_rows(x, ku, fill) if j < 0 else pieces[j][:, :, :ku]
             for j in range(i - m, i)], 2)[:, :, m * ku - up:])
    parts.append(x[:, :, max(-top, 0):h - max(-bottom, 0)])
    if down:
        m = -(-down // h)
        parts.append(torch.cat(
            [_fill_rows(x, kd, fill) if j >= n else pieces[j][:, :, ku:]
             for j in range(i + 1, i + 1 + m)], 2)[:, :, :down])
    out = torch.cat(parts, 2) if len(parts) > 1 else parts[0]
    if x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def window(x: torch.Tensor, win: Window,
           run: Callable[[torch.Tensor, Tuple[int, int]], torch.Tensor],
           fill: float = 0.0) -> torch.Tensor:
    """``run(t, rows)``, the windowed op on ``t`` with ``rows`` of padding
    (top, bottom; a transposed op reads the first as torch's
    ``padding``): ``run(x, win.pad)`` where no shards are active; on row
    shards ``run`` with no row padding on this shard's rows of ``x`` and
    the halo ``win`` reads (``fill`` past the image's edges), cropped to
    this shard's output rows."""
    sh = active()
    if sh is None:
        return run(x, win.pad)
    top, bottom, offset, ho = shard_halo(win, x.shape[2], sh.index,
                                         sh.count)
    y = run(halo(x, top, bottom, fill), (0, 0))
    if offset or y.shape[2] != ho:
        y = y[:, :, offset:offset + ho]
    return y


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean((2, 3), keepdim=True)`` over the whole image: on row
    shards the float32 sum of this shard's rows, all-reduced, over the
    global count, in x's dtype."""
    sh = active()
    if sh is None:
        return x.mean((2, 3), keepdim=True)
    s = x.sum((2, 3), keepdim=True, dtype=torch.float32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=sh.group)
    return (s / (x.shape[2] * sh.count * x.shape[3])).to(x.dtype)
