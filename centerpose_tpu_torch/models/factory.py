"""Model factory.

Counterpart of ``centerpose_tpu/models/factory.py`` for the slice ported so
far: ``dla_34`` only.  Other architecture names raise ``NotImplementedError``
(their order in the port is in ``ROADMAP.md``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from centerpose_tpu_torch.config import Config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.model.compute_dtype]


def create_model(cfg: Config) -> nn.Module:
    """A float32 CPU module wired with the task heads; callers move it with
    ``.to(device, dtype)`` (see ``Detector``)."""
    name = cfg.model.name
    if name != "dla_34":
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (only 'dla_34'); see ROADMAP.md")
    from centerpose_tpu_torch.models.dla import DLASeg

    return DLASeg(heads=cfg.model.heads(), head_conv=cfg.model.head_conv,
                  dcn_impl=cfg.model.dcn_impl,
                  dcn_max_dy=cfg.model.dcn_max_dy)
