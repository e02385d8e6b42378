"""Config system: typed dataclass tree + YAML/CLI merging.

Counterpart of ``centerpose_tpu/config/defaults.py``: the same dataclass
tree, the same knob names and the same dotted ``--opts`` keys, so that
``experiments/*.yaml`` load unchanged.  ``yaml`` is imported only when a file
path is given.  Knobs the port does not implement yet keep their fields (a
config stays loadable) and are refused where they are read.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    # Architecture name, e.g. 'res_18', 'res_50', 'dla_34', 'hrnet_w32',
    # 'mobilenetv2', 'mobilenetv3', 'shufflenetv2', 'hardnet', 'darknet',
    # 'efficientnet'.  (reference: cfg.MODEL.NAME)
    name: str = "res_18"
    # Channels of the per-head 3x3 conv before the 1x1 output conv.
    # Reference default: 256 for DLA, 64 for ResNet (cfg.MODEL.HEAD_CONV).
    head_conv: int = 64
    # Input / output resolution (stride-4 output grid).
    input_res: int = 512
    output_res: int = 128
    # Number of keypoints (COCO person = 17).
    num_joints: int = 17
    # Head channel spec; derived from the task in `heads()` below.
    # Initial bias of the heatmap 1x1 convs: -log((1-pi)/pi), pi=0.1.
    hm_bias: float = -2.19
    # Model dtype: 'float32' or 'bfloat16' (the heads return float32).
    compute_dtype: str = "float32"
    # DCNv2 site policy of the reference: 'xla' computes every site
    # unclamped; 'pallas' / 'pallas_full' clamp dy at the sites the
    # reference's fused kernels take (ops/dcn_cuda.py: site_max_dy).  The
    # port runs its own kernel either way.  'conv' is the reference's
    # ablation: a plain 3x3 conv at every site, no offsets, no DCN kernel
    # (models/dla.py: DCN).
    dcn_impl: str = "xla"
    # y-offset clamp radius under the pallas policies.  0 = the per-width
    # defaults (ops/dcn_cuda.DEFAULT_MAX_DY); a positive value forces that
    # radius (lowered to the row-major cap where the reference lowers it).
    dcn_max_dy: int = 0
    # Inference DCN sites inside the om-fused envelope take the om-fused
    # kernel (K1, ops/dcn_cuda.site_om_fused) where this is on, as the
    # reference's do; off, they compute the offset/mask conv in the
    # compute dtype and then the DCN from explicit offsets (K2), as the
    # reference's explicit path (models/dla.py: DCN).
    dcn_fused_om: bool = True
    # The reference's TPU layout switch (channel-second kernels); it
    # changes no value, and the port, which keeps one layout, ignores it.
    dcn_chsec: bool = True

    def heads(self) -> Dict[str, int]:
        """Head name -> channel count (reference: train.py heads dict)."""
        j = self.num_joints
        return {
            "hm": 1,
            "wh": 2,
            "hps": 2 * j,
            "reg": 2,
            "hm_hp": j,
            "hp_offset": 2,
        }


@dataclass
class LossConfig:
    # Loss weights (reference: cfg.LOSS.*_WEIGHT; defaults HM=HP=HM_HP=OFF=1,
    # WH=0.1).
    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    hp_weight: float = 1.0
    hm_hp_weight: float = 1.0
    # Which auxiliary heads are supervised (reference: LOSS.HM_HP,
    # LOSS.REG_OFFSET, LOSS.REG_HP_OFFSET).
    hm_hp: bool = True
    reg_offset: bool = True
    reg_hp_offset: bool = True
    # Dense joint regression (reference: LOSS.DENSE_HP, default False).
    dense_hp: bool = False


@dataclass
class DatasetConfig:
    dataset: str = "coco_hp"
    root: str = "data/coco"
    # Augmentation knobs (reference: DATASET.{SCALE,SHIFT,ROTATE,FLIP,...}).
    scale: float = 0.4
    shift: float = 0.1
    rotate: float = 0.0
    flip: float = 0.5
    no_color_aug: bool = False
    max_objs: int = 32
    mean: Tuple[float, float, float] = (0.408, 0.447, 0.470)
    std: Tuple[float, float, float] = (0.289, 0.274, 0.278)


@dataclass
class TrainConfig:
    lr: float = 1.25e-4
    lr_step: Tuple[int, ...] = (90, 120)
    epochs: int = 140
    # Global batch size (across all devices).
    batch_size: int = 32
    optimizer: str = "adam"
    resume: bool = False
    val_intervals: int = 5
    # Cap on images for the in-training detector-AP validation pass
    # (0 = the whole val split).  model_best is gated on this AP, matching
    # the reference's best-AP checkpointing (SURVEY.md §3.1).
    val_ap_limit: int = 0
    num_workers: int = 4
    # Host->device wire format for training batches: "float32" or
    # "compact" (uint8 images, f16 targets).
    wire: str = "float32"
    grad_accum: int = 1
    # Checkpointing.
    save_all: bool = False
    ckpt_every: int = 1  # epochs
    seed: int = 317


@dataclass
class TestConfig:
    test_scales: Tuple[float, ...] = (1.0,)
    flip_test: bool = False
    nms: bool = False  # soft-NMS merge (forced on under multi-scale)
    topk: int = 100
    vis_thresh: float = 0.3
    keep_res: bool = False
    # keep_res pads to a multiple of this (at least 32).  Set 32 for the
    # upstream padding; the default 128 keeps the JAX package's buckets.
    pad_bucket: int = 128
    model_path: str = ""


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    output_dir: str = "output"
    exp_id: str = "default"
    debug: int = 0
    task: str = "multi_pose"


def default_config() -> Config:
    return Config()


def _set_dotted(obj: Any, key: str, value: Any) -> None:
    """Set ``a.b.c`` on a dataclass tree with type coercion from the field."""
    parts = key.lower().split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {key}")
    cur = getattr(obj, leaf)
    if isinstance(cur, bool):
        if isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        else:
            value = bool(value)
    elif isinstance(cur, int) and not isinstance(value, bool):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    elif isinstance(cur, tuple):
        if isinstance(value, str):
            value = tuple(
                type(cur[0])(v) for v in value.strip("[]()").split(",") if v
            )
        else:
            value = tuple(value)
    setattr(obj, leaf, value)


def update_config(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Merge a flat dict of dotted keys (or nested dict) into a copy of cfg.

    Mirrors the reference's ``update_config(cfg, args)`` YAML+CLI merge.
    """
    cfg = copy.deepcopy(cfg)

    def apply(prefix: str, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                apply(key, v)
            else:
                _set_dotted(cfg, key, v)

    apply("", overrides)
    return cfg


def _apply_opts(cfg: Config, opts: Optional[List[str]]) -> Config:
    if not opts:
        return cfg
    if len(opts) % 2 != 0:
        raise ValueError("opts must be KEY VALUE pairs")
    return update_config(cfg, {opts[i]: opts[i + 1]
                               for i in range(0, len(opts), 2)})


def load_config(path: Optional[str] = None, opts: Optional[List[str]] = None) -> Config:
    """Load a YAML experiment file and apply ``KEY VALUE`` CLI override pairs.

    ``opts`` follows the reference CLI contract: a flat list alternating
    dotted keys and values, e.g. ``["train.lr", "1e-4", "test.flip_test",
    "true"]``.
    """
    cfg = default_config()
    if path:
        import yaml  # lazy; only needed when loading files

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        cfg = update_config(cfg, data)
    return _apply_opts(cfg, opts)


# experiments/dla_34_512x512.yaml as a dict, for callers that read no yaml
# (the card's machine has no PyYAML): dla_34 @512, the pallas_full DCN site
# policy, bfloat16, and its train block.
FLAGSHIP = {
    "model": {"name": "dla_34", "input_res": 512, "output_res": 128,
              "head_conv": 256, "dcn_impl": "pallas_full", "dcn_max_dy": 0,
              "compute_dtype": "bfloat16"},
    "train": {"lr": 1.25e-4, "lr_step": (90, 120), "epochs": 140,
              "batch_size": 32, "wire": "compact"},
}


def flagship_config(opts: Optional[List[str]] = None) -> Config:
    """The flagship config (``FLAGSHIP``) with ``KEY VALUE`` overrides."""
    return _apply_opts(update_config(default_config(), FLAGSHIP), opts)


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
