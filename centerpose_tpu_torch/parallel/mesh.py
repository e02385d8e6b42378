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
"""

from __future__ import annotations

import os
import warnings
from datetime import timedelta
from typing import Optional

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
