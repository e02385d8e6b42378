"""Sharded input pipeline: parallel GT encoding and device prefetch.

Counterpart of ``centerpose_tpu/data/loader.py``:

- ``DataLoader``: each process owns indices ``[shard_id::num_shards]`` of
  the epoch's permutation (seeded by ``(seed, epoch)``), cut to
  ``len(dataset) // num_shards`` so that every process yields
  ``steps_per_epoch()`` batches, and every example
  is encoded with its own generator seeded by ``(seed, epoch, idx)``, so a
  batch does not depend on the number of workers.  Encoding runs in a pool
  of spawned processes: the parent holds CUDA and threads by then, and a
  forked child of such a process can deadlock.  Workers see no CUDA device
  and run torch on one thread each (the encoder warps on a CPU tensor; N
  workers times torch's default thread pool would oversubscribe the host).
- ``prefetch_to_device``: a producer thread copies each batch into pinned
  host memory and on to the device with ``non_blocking`` copies on a side
  stream, ``size`` batches ahead; the consumer's stream waits on the
  batch's event before the batch is handed out, and an exception in the
  producer is raised on the consumer's side.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from centerpose_tpu_torch.data.encode import encode_example, stack_batch

# Worker-process globals (set once per worker by _init_worker).
_WORKER_DS = None
_WORKER_CFG = None


def _set_globals(dataset, cfg) -> None:
    global _WORKER_DS, _WORKER_CFG
    _WORKER_DS = dataset
    _WORKER_CFG = cfg


def _init_worker(dataset, cfg) -> None:
    _set_globals(dataset, cfg)
    torch.set_num_threads(1)


def _encode_index(args) -> Dict[str, np.ndarray]:
    idx, seed, is_train = args
    rng = np.random.default_rng(seed)
    img, anns = _WORKER_DS.get_raw(idx)
    ex = encode_example(img, anns, _WORKER_CFG, rng, is_train)
    ex.pop("c", None)
    ex.pop("s", None)
    return ex


class DataLoader:
    """Epoch-based loader over any dataset with ``__len__`` and
    ``get_raw(i) -> (image, annotations)``; the dataset and the config
    must pickle (they are sent to each worker once)."""

    def __init__(self, dataset, cfg, batch_size: int, is_train: bool = True,
                 num_workers: int = 0, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1, drop_last: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.is_train = is_train
        self.num_workers = num_workers
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self._pool: Optional[ProcessPoolExecutor] = None

    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            # the workers start now, while CUDA is hidden from them
            prev = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_init_worker,
                    initargs=(self.dataset, self.cfg))
                list(self._pool.map(int, range(self.num_workers)))
            finally:
                if prev is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = prev
        return self._pool

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield stacked numpy batches of this process's shard of the
        epoch."""
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(n) if self.is_train else np.arange(n)
        # every shard the same length, len(dataset) // num_shards, so each
        # rank yields steps_per_epoch() batches (a rank with one more
        # would wait forever in its extra step's collectives); batch k of
        # the shards together is order[k * B:(k + 1) * B] for the global B
        local = order[self.shard_id::self.num_shards][:n // self.num_shards]
        nb = len(local) // self.batch_size
        if not self.drop_last and len(local) % self.batch_size:
            nb += 1
        args = [(int(idx), (self.seed, epoch, int(idx)), self.is_train)
                for idx in local]
        if self.num_workers > 0:
            it = self._ensure_pool().map(_encode_index, args, chunksize=4)
        else:
            _set_globals(self.dataset, self.cfg)
            it = map(_encode_index, args)
        buf: List[dict] = []
        produced = 0
        for ex in it:
            buf.append(ex)
            if len(buf) == self.batch_size:
                yield stack_batch(buf)
                buf = []
                produced += 1
                if produced >= nb:
                    break
        if buf and not self.drop_last and produced < nb:
            yield stack_batch(buf)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _to_device(batch: Dict[str, np.ndarray], device: torch.device,
               stream) -> Dict[str, torch.Tensor]:
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    with torch.cuda.stream(stream):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(device, non_blocking=True) for k, v in batch.items()}


def prefetch_to_device(host_iter: Iterator[Dict[str, np.ndarray]],
                       device: str | torch.device = "cuda",
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Overlap host batch production and the host-to-device copy with the
    device's work: a thread keeps up to ``size`` batches copied ahead.

    On a CUDA device each batch is copied from pinned memory on a side
    stream; before a batch is yielded the consumer's current stream waits
    on the copy's event and each tensor is recorded on that stream, so the
    caching allocator keeps its memory until the consumer's work is done.
    """
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def producer():
        try:
            for batch in host_iter:
                if stop.is_set():
                    return
                dev = _to_device(batch, device, side)
                event = None
                if side is not None:
                    event = torch.cuda.Event()
                    event.record(side)
                q.put((dev, event))
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                break
            dev, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in dev.values():
                    v.record_stream(consumer)
            yield dev
    finally:
        # a consumer that stops early lets the producer finish its put
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
