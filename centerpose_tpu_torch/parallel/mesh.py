"""Data-parallel training across processes: DDP with global reductions.

Counterpart of ``centerpose_tpu/parallel/mesh.py``.  The reference jits
one SPMD train step over a batch sharded ``P('data')`` across every
device, so each reduction in the step (BatchNorm's statistics, the loss
normalizers, the gradient) runs over the global batch.  Here one process
drives one device and holds one shard of the batch (``data/loader.
DataLoader``'s ``shard_id``/``num_shards``); the same reductions become
collectives of a ``torch.distributed`` process group:

- the gradient: ``DistributedDataParallel``'s bucket all-reduce, an average
  over the ranks (``data_parallel``);
- BatchNorm's statistics and its input gradient's two channel sums:
  ``models/common.BatchNorm2d`` with ``process_group`` set
  (``sync_batch_norm``);
- the loss normalizers: ``losses.multi_pose_loss(group=...)``.

``init_distributed`` joins the group (torchrun's environment, or an
explicit rendezvous); ``process_index`` and ``process_count`` read it, 0
and 1 where none was joined.  Every collective is issued in the same order
on every rank: the model and its autograd graph are the same on each, and
the group's timeout turns a mismatch into an error, not a hang.

Spatial sharding of the serving forward (``create_mesh_2d``,
``spatial_sharding``; the reference's functions of the same names): a
("data", "spatial") grid of ranks, the batch split over the first and the
image rows over the second; the forward runs on row shards through
``parallel/spatial.py`` and the heads are gathered back.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

# How long a collective may wait for the other ranks before it raises
# (torch's own default for gloo).
DEFAULT_TIMEOUT_S = 1800.0


def default_backend(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: str | torch.device = "cuda",
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group (reference analog:
    ``jax.distributed.initialize``).

    With no address, torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) rendezvous through ``env://``;
    otherwise ``coordinator_address`` is a rendezvous URL (``tcp://host:
    port``, ``file:///path``; a bare ``host:port`` means tcp) for
    ``num_processes`` ranks, this one ``process_id``.  ``backend``:
    ``default_backend(device)`` unless named.  ``timeout``: seconds a
    collective waits for the others before it raises."""
    if backend is None:
        backend = default_backend(device)
    kwargs = {"timeout": timedelta(seconds=timeout)}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    else:
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        kwargs.update(init_method=coordinator_address,
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, **kwargs)


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """The rank among this host's processes (torchrun's ``LOCAL_RANK``),
    which names the card a process drives; 0 outside torchrun."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def group_size(group) -> int:
    """The size of ``group`` (a process group or None); 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (one stacked float32 tensor) summed over the ranks of
    ``group``, in place; returned."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Point every ``models/common.BatchNorm2d`` of ``model`` at ``group``:
    its train-mode statistics and input gradient then reduce over the
    group's global batch (None, or a group of one, keeps them local)."""
    from centerpose_tpu_torch.models.common import BatchNorm2d

    if group_size(group) == 1:
        group = None
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return model


def data_parallel(model: nn.Module, device: torch.device,
                  group) -> nn.parallel.DistributedDataParallel:
    """``model`` wrapped for data parallelism over ``group``: each
    backward all-reduces the gradient as the ranks' average.  Buffers are
    not broadcast from rank 0 at each forward (the synchronised BatchNorm
    keeps them equal, and a BatchNorm that failed to would show).  Some
    factory names have parameters no loss term reaches (hrnet's last
    fuse, efficientnet's last bottom-up path): they are found at each
    forward and keep no gradient (``find_unused_parameters``), as in one
    process; the model's own names stay on ``model``."""
    with warnings.catch_warnings():
        # newer torch deprecates broadcast_buffers for a name that keeps
        # the per-forward broadcast apart from the one at init
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*")
        return nn.parallel.DistributedDataParallel(
            model, device_ids=_device_ids(device), process_group=group,
            broadcast_buffers=False, find_unused_parameters=True)


def _device_ids(device: torch.device):
    """DDP's ``device_ids``: the card's index (the current one for a bare
    ``cuda``), None on the CPU."""
    if device.type != "cuda":
        return None
    return [torch.cuda.current_device() if device.index is None
            else device.index]


# ---------------------------------------------------------------- 2-D mesh


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ("data", "spatial") grid of ``n_data`` x ``n_spatial`` ranks (the
    reference's ``Mesh(devices.reshape(n_data, n_spatial), ("data",
    "spatial"))``): this rank sits at (``data_index``, ``spatial_index``);
    ``spatial_group`` holds its row of the grid (the ranks that split one
    image's rows), ``data_group`` its column (the ranks that split the
    batch).  A group of one rank is None.  ``member``: False on a rank past
    the grid's first ``n_data * n_spatial`` ranks, which takes no part."""

    n_data: int
    n_spatial: int
    data_index: int = 0
    spatial_index: int = 0
    data_group: object = None
    spatial_group: object = None
    member: bool = True


def create_mesh_2d(n_data: int, n_spatial: int, group=None) -> Mesh2D:
    """The (data, spatial) mesh over the first ``n_data * n_spatial``
    ranks of ``group`` (the default group when None), rank r of them at
    (r // n_spatial, r % n_spatial), as the reference reshapes
    ``devices[:n_data * n_spatial]``.  Every rank of the default group
    calls it (each new group is made by all).  Without a process group,
    only the 1 x 1 mesh."""
    n = n_data * n_spatial
    if n < 1:
        raise ValueError(f"mesh {n_data} x {n_spatial}")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {n_data} x {n_spatial} mesh needs a "
                               "process group (init_distributed)")
        return Mesh2D(1, 1)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    if len(ranks) < n:
        raise ValueError(f"a {n_data} x {n_spatial} mesh needs {n} ranks, "
                         f"the group has {len(ranks)}")
    grid = [ranks[d * n_spatial:(d + 1) * n_spatial] for d in range(n_data)]

    def groups(members):
        # every rank makes every group, in the same order
        made = [dist.new_group(m) if len(m) > 1 else None for m in members]
        return {r: g for m, g in zip(members, made) for r in m}

    spatial = groups(grid)
    data = groups([[row[s] for row in grid] for s in range(n_spatial)])
    me = dist.get_rank()
    if me not in spatial:
        return Mesh2D(n_data, n_spatial, member=False)
    at = ranks.index(me)
    return Mesh2D(n_data, n_spatial, at // n_spatial, at % n_spatial,
                  data[me], spatial[me])


class SpatialSharding:
    """[B, H, W, C] arrays with the batch over the mesh's ``data`` axis and
    the image rows over its ``spatial`` axis (the reference's
    ``NamedSharding(mesh, P("data", "spatial"))``): ``shard`` takes this
    rank's block of an array every rank holds, ``gather`` puts the blocks
    back together on every rank, ``forward`` runs a model on the blocks
    and returns its heads whole."""

    def __init__(self, mesh: Mesh2D):
        if not mesh.member:
            raise ValueError("this rank is not in the mesh")
        self.mesh = mesh

    def rows(self, images: torch.Tensor):
        """This rank's ``spatial.RowShards`` of the [B, H, W, C] ``images``
        (``spatial.row_split``: whole stride-32 rows, the earlier shards one
        more where they do not split evenly); None on a 1-wide axis."""
        from centerpose_tpu_torch.parallel.spatial import (CELL, RowShards,
                                                           row_split)

        m = self.mesh
        if m.n_spatial == 1:
            return None
        h, w = images.shape[1], images.shape[2]
        rows = row_split(h, m.n_spatial)
        if 0 in rows and w % CELL:
            raise ValueError(f"an image of {h} x {w} leaves a shard of the "
                             f"{m.n_spatial} no rows, and such a shard "
                             f"reads its levels' heights from their widths: "
                             f"the width must be a multiple of {CELL}")
        return RowShards(m.spatial_group, m.spatial_index, m.n_spatial, rows,
                         w)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the [B, H, W, ...] ``x``: B / n_data images
        and its rows of the split (``rows``)."""
        m = self.mesh
        b = x.shape[0]
        if b % m.n_data:
            raise ValueError(f"a batch of {b} does not split over a "
                             f"{m.n_data} x {m.n_spatial} mesh")
        bl = b // m.n_data
        x = x[m.data_index * bl:(m.data_index + 1) * bl]
        sh = self.rows(x)
        if sh is None:
            return x
        first = sum(sh.rows[:sh.index])
        return x[:, first:first + sh.rows[sh.index]]

    def gather(self, y: torch.Tensor, heights) -> torch.Tensor:
        """The whole [B, H, ...] array of every rank's ``shard`` block
        ``y``: rows over the spatial group, then batch over the data
        group, bit for bit.  ``heights``: each spatial rank's rows of y's
        level (``RowShards.heights``; None on a 1-wide spatial axis); the
        blocks move padded to the most rows and are cropped back."""
        from centerpose_tpu_torch.parallel.spatial import all_gather_exact

        m = self.mesh
        y = y.contiguous()
        if m.n_spatial > 1:
            most = max(heights)
            if y.shape[1] < most:
                y = torch.cat([y, y.new_zeros((y.shape[0], most - y.shape[1],
                                               *y.shape[2:]))], 1)
            blocks = all_gather_exact(y, m.spatial_group, m.n_spatial,
                                      m.spatial_index)
            y = torch.cat([blk[:, :n] for blk, n in zip(blocks, heights)], 1)
        if m.n_data > 1:
            y = torch.cat(list(all_gather_exact(
                y, m.data_group, m.n_data, m.data_index)), 0)
        return y

    def forward(self, model: torch.nn.Module,
                images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``model(images)``'s heads ([B, H/4, W/4, C] each, NHWC), the
        model run on this rank's block of ``images`` with its windowed
        ops on row shards.  An eval forward only: the reference shards no
        training step (BatchNorm's train statistics would be the
        shard's)."""
        from centerpose_tpu_torch.parallel.spatial import row_sharded

        if model.training:
            raise ValueError("row shards run the eval forward only")
        rows = self.rows(images)
        with row_sharded(rows):
            out = model(self.shard(images))
        return {k: self.gather(v, None if rows is None else
                               rows.heights(v.shape[1], v.shape[2]))
                for k, v in out.items()}


def spatial_sharding(mesh: Mesh2D) -> SpatialSharding:
    """[B, H, W, C] arrays: batch over 'data', image rows over 'spatial'
    (the reference's function of this name)."""
    return SpatialSharding(mesh)
