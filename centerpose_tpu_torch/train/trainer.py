"""Training step, optimizer and train state.

Counterpart of ``centerpose_tpu/train/trainer.py``:

- ``unpack_batch``: the device-side decode of the compact wire (uint8
  image -> /255 -> colour-aug replay from the 6 coefficients -> normalise;
  float16 targets -> float32), a no-op on the float32 wire;
- ``make_lr_schedule`` / ``Optimizer``: optax's ``adam`` (b1 0.9, b2 0.999,
  eps 1e-8) or ``sgd`` with momentum 0.9, under the step-decay schedule
  (``piecewise_constant_schedule``: x0.1 from update ``e * steps_per_epoch``
  on, inclusive), wrapped in ``MultiSteps`` when ``train.grad_accum`` > 1
  (the mean of k micro-batch gradients, one update every k calls; the
  schedule counts updates);
- ``Trainer``: the train state (any name of ``models/factory.
  MODEL_FACTORY``: dla_34, the resnets, hrnets, mobilenets, shufflenetv2,
  hardnet, darknet, efficientnet; float32 master parameters, the compute
  dtype cast at use, optional snapshot weights; ``state`` and
  ``load_state`` for checkpoints), ``train_step``
  (``make_train_step``: forward in train mode, ``multi_pose_loss``,
  backward, update; BatchNorm statistics advance on every call, those
  whose output no loss term reads too, as the reference's train step
  returns them; the parameters feeding only those get no gradient and
  keep no optimizer state, where optax's zero gradient leaves them as
  they were too) and ``eval_step`` (``make_eval_step``: running
  statistics, no update); with a process ``group``, data-parallel over
  its ranks (``parallel/mesh.py``: DDP, BatchNorm and the loss over the
  global batch), each rank holding a shard of the batch.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from centerpose_tpu_torch.losses import multi_pose_loss
from centerpose_tpu_torch.models.common import (set_compute_dtype,
                                                to_channels_last)
from centerpose_tpu_torch.models.factory import create_model, model_dtype
from centerpose_tpu_torch.parallel.mesh import (data_parallel, group_size,
                                                sync_batch_norm)
from centerpose_tpu_torch.utils.platform import resolve_device
from centerpose_tpu_torch.utils.profiling import span
from centerpose_tpu_torch.weights import load_state_dict

# keys of an encoded example that only the evaluator reads
_META_KEYS = ("c", "s")
_GRAY = (0.299, 0.587, 0.114)


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """A stacked batch (``data/encode.stack_batch``'s numpy arrays, or
    tensors, e.g. from ``data/loader.prefetch_to_device``) as tensors on
    ``device``, without the meta keys; dtypes unchanged."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(
                    device, non_blocking=True)
            for k, v in batch.items() if k not in _META_KEYS}


def unpack_batch(batch: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """Device-side decode of the compact wire.  A uint8 ``input`` is
    scaled to [0, 1], its colour augmentation replayed from ``aug``
    (``x' = A x + c_gs gs + c_mean mean(gs) + pca``, with gs computed from
    the pre-aug image as the host's ``color_aug`` does), and normalised;
    float16 targets become float32.  The float32 wire passes through."""
    b = dict(batch)
    x = b["input"]
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
        aug = b.pop("aug", None)
        if aug is not None:
            aug = aug.float()
            gs = x @ torch.tensor(_GRAY, dtype=torch.float32, device=x.device)
            gs_mean = gs.mean(dim=(1, 2))
            x = (aug[:, 0, None, None, None] * x
                 + aug[:, 1, None, None, None] * gs[..., None]
                 + aug[:, 2, None, None, None] * gs_mean[:, None, None, None]
                 + aug[:, None, None, 3:6])
        mean = torch.tensor(cfg.dataset.mean, dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(cfg.dataset.std, dtype=torch.float32,
                           device=x.device)
        b["input"] = (x - mean) / std
    for k, v in b.items():
        if k != "input" and v.dtype == torch.float16:
            b[k] = v.float()
    return b


def make_lr_schedule(cfg, steps_per_epoch: int):
    """update index -> learning rate: ``train.lr``, x0.1 at each update
    ``e * steps_per_epoch`` for e in ``train.lr_step`` (from it on)."""
    bounds = sorted({int(e) * steps_per_epoch for e in cfg.train.lr_step})
    lr0 = float(cfg.train.lr)

    def schedule(count: int) -> float:
        v = lr0
        for b in bounds:
            if count >= b:
                v *= 0.1
        return v

    return schedule


class Optimizer:
    """Adam or SGD-momentum under the step-decay schedule, with optax
    ``MultiSteps`` gradient accumulation.  ``step()`` is called once per
    micro-batch, after its backward has left the gradient in ``.grad``
    (PyTorch's accumulation sums over micro-batches; the update divides by
    k).  Returns True when it applied an update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg,
                 steps_per_epoch: int = 1000):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.every_k = max(1, int(cfg.train.grad_accum))
        name = cfg.train.optimizer
        if name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=self.schedule(0),
                                        betas=(0.9, 0.999), eps=1e-8)
        elif name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=self.schedule(0),
                                       momentum=0.9)
        else:
            raise ValueError(f"unknown optimizer {name}")
        self.updates = 0  # applied updates: the schedule's position
        self.mini_step = 0  # micro-batches accumulated since the last one

    def updates_next(self) -> bool:
        """Whether the next ``step()`` applies an update."""
        return self.mini_step + 1 >= self.every_k

    def step(self) -> bool:
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        if self.every_k > 1:
            for p in self.params:
                if p.grad is not None:
                    p.grad.div_(self.every_k)
        lr = self.schedule(self.updates)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1
        self.mini_step = 0
        return True

    def state_shapes(self, p: torch.Tensor) -> Dict[str, tuple]:
        """The names and shapes of the state torch's optimizer keeps for
        parameter ``p`` once it has stepped."""
        if isinstance(self.opt, torch.optim.Adam):
            return {"step": (), "exp_avg": tuple(p.shape),
                    "exp_avg_sq": tuple(p.shape)}
        return {"momentum_buffer": tuple(p.shape)}

    def state_dict(self) -> dict:
        """The optimizer's state: torch's (Adam's moments and step counts,
        or SGD's momentum), the schedule's position and, mid-accumulation,
        the gradients summed so far."""
        acc = [p.grad for p in self.params] if self.mini_step else None
        return {"opt": self.opt.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step, "acc_grads": acc}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.updates = int(sd["updates"])
        self.mini_step = int(sd["mini_step"])
        acc = sd["acc_grads"] or [None] * len(self.params)
        for p, g in zip(self.params, acc):
            p.grad = None if g is None else g.to(p.device, p.dtype).clone()


class Trainer:
    """The train state of one model on one device and its two steps.

    ``cfg`` names the model and the training knobs; ``state_dict`` (from
    ``weights.state_dict_from_npz``) sets the starting weights, else the
    modules' own random init, seeded from ``cfg.train.seed`` on a forked
    RNG (the process's RNG is left as it was).  ``step`` counts
    ``train_step`` calls; ``state()`` and ``load_state()`` carry the whole
    train state (step, parameters, BatchNorm statistics, optimizer and
    schedule) for checkpoints (``train/checkpoints.py``).

    ``group``: a ``torch.distributed`` process group (data parallelism
    over its ranks, one device each, every rank feeding its shard of the
    global batch) or None.  ``model`` stays the module itself (its state
    names as in one process); ``ddp`` wraps it
    (``parallel/mesh.data_parallel``) and runs the train steps, with
    BatchNorm synchronised and the loss on global normalizers where the
    group has more than one rank.  The optimizer's state is laid out as in
    one process, so either loads the other's checkpoints."""

    def __init__(self, cfg, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device: str | torch.device = "cuda",
                 steps_per_epoch: int = 1000, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.train.seed)
            model = create_model(cfg)
        if state_dict is not None:
            load_state_dict(model, state_dict)
        self.model = set_compute_dtype(
            to_channels_last(model.to(self.device)), model_dtype(cfg)).train()
        self.optimizer = Optimizer(self.model.parameters(), cfg,
                                   steps_per_epoch)
        self.step = 0
        self.ddp = None
        if group is not None:
            sync_batch_norm(self.model, group)
            self.ddp = data_parallel(self.model, self.device, group)
        # the loss's group: None in one process or a group of one
        self._loss_group = group if group_size(group) > 1 else None

    def state(self) -> dict:
        """The train state as live tensors: ``step``, ``model`` (the float32
        master parameters by name), ``bn`` (the buffers by name: BatchNorm's
        statistics and counters, the fixed upsample kernels) and
        ``optimizer`` (``Optimizer.state_dict``)."""
        return {"step": self.step,
                "model": dict(self.model.named_parameters()),
                "bn": dict(self.model.named_buffers()),
                "optimizer": self.optimizer.state_dict()}

    @torch.no_grad()
    def load_state(self, state: Mapping) -> None:
        """Set the train state from ``state()``'s layout (tensors on any
        device); shapes must match (``checkpoints.restore_state`` checks
        them first)."""
        for group in ("model", "bn"):
            live = (dict(self.model.named_parameters()) if group == "model"
                    else dict(self.model.named_buffers()))
            for name, t in live.items():
                t.copy_(state[group][name])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def _loss(self, batch: Mapping[str, np.ndarray], net=None):
        with span("train.upload"):
            b = unpack_batch(batch_to_device(batch, self.device), self.cfg)
        with span("train.forward"):
            outputs = (net or self.model)(b["input"])
            return multi_pose_loss(outputs, b, self.cfg, self._loss_group)

    def backward(self, batch: Mapping[str, np.ndarray],
                 sync: bool = True) -> Dict[str, torch.Tensor]:
        """Forward in train mode (BatchNorm statistics advance), loss and
        backward on a stacked batch: the gradients are added to ``.grad``
        (with a group, all-reduced to the ranks' average unless ``sync``
        is False: then each rank keeps its own sum, ``no_sync``).  Returns
        the loss stats as detached device scalars."""
        self.model.train()
        quiet = self.ddp is not None and not sync
        with (self.ddp.no_sync() if quiet else contextlib.nullcontext()):
            loss, stats = self._loss(batch, self.ddp)
            with span("train.backward"):
                loss.backward()
        return {k: v.detach() for k, v in stats.items()}

    def train_step(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One step on a stacked batch: ``backward``, then the optimizer (an
        update every ``grad_accum`` calls; with a group, the micro-batches
        before an update leave their gradients unsynchronised, and the
        update's all-reduce averages their sum).  Returns the loss stats as
        detached device scalars (read them with ``float``)."""
        with span("train.step"):
            stats = self.backward(batch, sync=self.optimizer.updates_next())
            with span("train.optimizer"):
                self.optimizer.step()
        self.step += 1
        return stats

    @torch.no_grad()
    def eval_step(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Loss stats in eval mode (running BatchNorm statistics, the
        inference DCN path; with a group, the global batch's loss, as in
        ``train_step``); the state is left as it was."""
        self.model.eval()
        try:
            _, stats = self._loss(batch)
        finally:
            self.model.train()
        return stats
