"""What the harness takes from the program under test (the PyTorch and CUDA
port, ``centerpose_tpu_torch``): its configuration object, its serving
entry and its training step, built from a configuration file.  Imported
only inside the functions, so that the harness's own modules load without
the program."""

from __future__ import annotations

import hashlib
from pathlib import Path

import torch


def set_tf32(cfg: dict) -> None:
    """A float32 configuration computes in float32 on the card: cuDNN's and
    cuBLAS's TF32 off, as the port's float32 tools set it
    (``tools/evaluate.no_tf32``).  Any other configuration runs under
    PyTorch's defaults, as the port's serving and training entries leave
    them."""
    if cfg["precision"] == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def snapshot(root: Path, cfg: dict) -> str:
    """The snapshot's path, after checking its sha256 against the
    configuration file's: the weights are part of the yardstick."""
    path = root / cfg["snapshot"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfg["snapshot_sha256"]:
        raise RuntimeError(f"{cfg['snapshot']}: sha256 {digest} is not the "
                           f"configuration's {cfg['snapshot_sha256']}")
    return str(path)


def port_config(cfg: dict, **overrides):
    """The port's ``Config`` of the configuration file ``cfg``."""
    from centerpose_tpu_torch.config import default_config, update_config

    c = update_config(default_config(), cfg["program"])
    return update_config(c, overrides) if overrides else c


def detector(root: Path, cfg: dict, device: str, **overrides):
    """The port's serving engine (``inference/detector.Detector``) with the
    snapshot's weights, on ``device``."""
    from centerpose_tpu_torch.inference.detector import Detector
    from centerpose_tpu_torch.weights import state_dict_from_npz

    sd = state_dict_from_npz(snapshot(root, cfg))
    return Detector(port_config(cfg, **overrides), sd, device=device)


def trainer(root: Path, cfg: dict, device: str, **overrides):
    """The port's train state (``train/trainer.Trainer``: float32 master
    parameters from the snapshot, Adam) on ``device``."""
    from centerpose_tpu_torch.train.trainer import Trainer
    from centerpose_tpu_torch.weights import state_dict_from_npz

    sd = state_dict_from_npz(snapshot(root, cfg))
    return Trainer(port_config(cfg, **overrides), sd, device=device)
