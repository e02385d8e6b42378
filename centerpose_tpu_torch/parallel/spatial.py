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
  halo spans (shards of unequal, even zero, heights), and ``fill`` (zero,
  or ``-inf`` for a max pool) past the image's global top and bottom.  The
  neighbours' edge rows (``edge_rows``, each rank's padded to the largest
  halo of any rank) move by one ``all_reduce`` (sum) of a zero buffer in
  which each rank writes its own rows, seen as bytes: a sum with zeros is
  exact for any dtype, and both backends take ``all_reduce`` on CUDA
  tensors (NCCL refuses two ranks on one card, and gloo takes no CUDA
  tensor in ``send``/``recv`` or ``all_gather``; its ``all_reduce`` stages
  them through the host).
* **The ops** (``window``, ``mean_hw``): a windowed op on its exchanged rows,
  and the mean over H and W as an all-reduced sum.

**The split** (``row_split``, ``RowShards``): whole stride-32 rows of the
image ("cells", ``CELL``), the earlier shards one cell more where the cells
do not split evenly (34 cells over 4: 9/9/8/8; 3 over 4: 1/1/1/0, a shard
with no rows).  A level of stride s then holds ``cells * 32 / s`` rows on
each shard: every row-local op (BatchNorm, the activations, the sums of
two levels, the nearest upsample) lines up across levels, and every
strided window maps shard to shard.  The split is a pure function of the
image's height and the shard count, the same on every rank; each rank
derives every shard's rows at a level from its own (or, holding none, from
the level's width), so nothing is exchanged to learn them.  GSPMD instead
pads each array to ``ceil(H_l / n)`` rows per shard; there 13 rows over 4
upsample to 8/8/8/2 while the 26-row level they are added to splits
7/7/7/5, so that layout is not copied.  The image height must be
divisible by the shard count (the reference's condition) and a multiple of
32 (the pre-process gives no other); another height raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


# The models' total stride: a cell, the unit of the split, is one row of
# the stride-32 level (CELL rows of the image).
CELL = 32


def row_split(h: int, count: int) -> Tuple[int, ...]:
    """The image rows of each of ``count`` shards (top to bottom) of an
    image ``h`` rows high: whole cells of CELL rows, the earlier shards one
    cell more where they do not split evenly.  Raises unless ``h`` is
    divisible by ``count`` and a multiple of CELL."""
    if h % count:
        raise ValueError(f"an image of {h} rows does not split over {count} "
                         f"shards: its height must be divisible by the "
                         f"shard count")
    if h % CELL:
        raise ValueError(f"an image of {h} rows does not split into the "
                         f"model's stride-{CELL} rows: its height must be a "
                         f"multiple of {CELL}")
    cells = h // CELL
    return tuple(CELL * (cells // count + (i < cells % count))
                 for i in range(count))


@dataclasses.dataclass(frozen=True)
class RowShards:
    """This rank's place in the image rows: shard ``index`` of ``count``
    (top to bottom), the others reached over ``group`` (None for one
    shard).  ``rows``: each shard's rows of the level the split was made
    at (the image, ``row_split``), ``width`` that level's columns."""

    group: object
    index: int
    count: int
    rows: Tuple[int, ...]
    width: int

    def heights(self, h: int, w: int) -> Tuple[int, ...]:
        """Each shard's rows of the level of which this shard holds ``h``
        rows of ``w`` columns: the split's rows scaled by this shard's own
        share, or, where it holds none, by the level's width."""
        own = self.rows[self.index]
        num, den = (h, own) if own else (w, self.width)
        if any(r * num % den for r in self.rows):
            raise ValueError(f"a level of {h} x {w} on shard {self.index} "
                             f"does not split as the rows {self.rows} of "
                             f"{self.width} columns")
        return tuple(r * num // den for r in self.rows)


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


def global_rows(x: torch.Tensor) -> int:
    """The image-wide height of the level of the NCHW ``x`` (this shard's
    rows of it on row shards)."""
    sh = active()
    if sh is None:
        return x.shape[2]
    return sum(sh.heights(x.shape[2], x.shape[3]))


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


def split_out(win: Window, heights) -> Tuple[int, ...]:
    """Each shard's output rows of the op on shards of ``heights`` input
    rows: the whole output split as the input is (whole cells map to whole
    cells).  Raises where it does not split so."""
    total_in = sum(heights)
    total = out_rows(win, total_in)
    if any(h * total % total_in for h in heights):
        raise ValueError(f"{total} output rows of {win} do not split as the "
                         f"input rows {tuple(heights)}: the image height "
                         f"must be a multiple of {CELL}")
    return tuple(h * total // total_in for h in heights)


def shard_halo(win: Window, heights, index: int
               ) -> Tuple[int, int, int, int]:
    """(top, bottom, offset, rows out) of shard ``index`` of shards of
    ``heights`` input rows: the rows above and below the shard its output
    shard reads (negative: that many of its own it does not read), where
    its output begins in the op's output on them, and its output rows.  A
    shard with no output rows reads none: (0, 0, 0, 0)."""
    out = split_out(win, heights)
    ho = out[index]
    if not ho:
        return 0, 0, 0, 0
    lo = sum(out[:index])
    first, end, offset = window_rows(win, lo, lo + ho)
    start = sum(heights[:index])
    return start - first, end - start - heights[index], offset, ho


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


def edge_rows(x: torch.Tensor, reach: Tuple[int, int]) -> torch.Tensor:
    """What a shard of the NCHW ``x`` hands the others for halos of at most
    ``reach`` = (up, down) rows: its last min(h, up) rows, zero rows up to
    ``up``, its first min(h, down) rows, zero rows up to ``down``."""
    up, down = reach
    h = x.shape[2]
    ku, kd = min(h, up), min(h, down)
    return torch.cat([x[:, :, h - ku:], _fill_rows(x, up - ku, 0.0),
                      x[:, :, :kd], _fill_rows(x, down - kd, 0.0)], 2)


def assemble(x: torch.Tensor, pieces, heights, index: int, top: int,
             bottom: int, up: int, fill: float = 0.0) -> torch.Tensor:
    """Shard ``index``'s rows of the NCHW ``x`` with ``top`` rows above and
    ``bottom`` below (a negative count drops that many of its own): the
    rows of the shards above and below, nearest first, from ``pieces``
    (every shard's ``edge_rows``, ``up`` rows up), as many shards as it
    takes; ``fill`` past the image's top and bottom.  ``heights``: every
    shard's rows of x."""
    h = x.shape[2]
    above, need, j = [], max(top, 0), index - 1
    while need:
        if j < 0:
            above.append(_fill_rows(x, need, fill))
            break
        ku, take = min(heights[j], up), min(heights[j], need)
        above.append(pieces[j][:, :, ku - take:ku])
        need, j = need - take, j - 1
    parts = above[::-1] + [x[:, :, max(-top, 0):h - max(-bottom, 0)]]
    need, j = max(bottom, 0), index + 1
    while need:
        if j == len(heights):
            parts.append(_fill_rows(x, need, fill))
            break
        take = min(heights[j], need)
        parts.append(pieces[j][:, :, up:up + take])
        need, j = need - take, j + 1
    out = torch.cat(parts, 2) if len(parts) > 1 else parts[0]
    if x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def halo(x: torch.Tensor, top: int, bottom: int, fill: float = 0.0,
         reach: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """This shard's rows of the NCHW ``x`` with ``top`` rows above and
    ``bottom`` below (a negative count drops that many of its own).  Rows
    past the image's top or bottom are ``fill``; the others come from the
    shards above and below, as many as the halo spans.  ``reach``: the
    largest (top, bottom) of any rank, the same on every rank; None where
    every rank passes the same counts.  Inside ``row_sharded``: every rank
    of the group calls it with the same ``reach`` and the same x but for
    its rows."""
    sh = active()
    heights = sh.heights(x.shape[2], x.shape[3])
    if reach is None:
        reach = (max(top, 0), max(bottom, 0))
    pieces = None
    if sum(reach):
        pieces = all_gather_exact(edge_rows(x, reach), sh.group, sh.count,
                                  sh.index)
    return assemble(x, pieces, heights, sh.index, top, bottom, reach[0],
                    fill)


def window(x: torch.Tensor, win: Window,
           run: Callable[[torch.Tensor, Tuple[int, int]], torch.Tensor],
           fill: float = 0.0) -> torch.Tensor:
    """``run(t, rows)``, the windowed op on ``t`` with ``rows`` of padding
    (top, bottom; a transposed op reads the first as torch's
    ``padding``): ``run(x, win.pad)`` where no shards are active; on row
    shards ``run`` with no row padding on this shard's rows of ``x`` and
    the halo ``win`` reads (``fill`` past the image's edges), cropped to
    this shard's output rows.  A shard with no output rows takes part in
    the exchange and returns no rows (in the channels and dtype of ``run``
    on as few zero rows as give one row)."""
    sh = active()
    if sh is None:
        return run(x, win.pad)
    heights = sh.heights(x.shape[2], x.shape[3])
    halos = [shard_halo(win, heights, j) for j in range(sh.count)]
    top, bottom, offset, ho = halos[sh.index]
    reach = (max(max(t[0], 0) for t in halos),
             max(max(t[1], 0) for t in halos))
    rows = halo(x, top, bottom, fill, reach)
    if not ho:
        b, c, _, w = x.shape
        one = x.new_zeros((b, c, 1 if win.transposed else win.span, w))
        return run(one, (0, 0))[:, :, :0]
    y = run(rows, (0, 0))
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
    return (s / (global_rows(x) * x.shape[3])).to(x.dtype)
