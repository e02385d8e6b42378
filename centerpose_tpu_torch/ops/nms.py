"""Peak extraction primitives (NHWC), counterparts of
``centerpose_tpu/ops/nms.py``.

Top-K is a stable descending sort cut at K, so equal scores come out
lowest index first, as ``lax.top_k`` orders them (fault watch F-D: flat or
clamped heatmaps tie often).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def heat_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """3x3 max-pool NMS on [B, H, W, C]: non-peaks zeroed."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad)
    hmax = hmax.permute(0, 2, 3, 1)
    return heat * (hmax == heat).to(heat.dtype)


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B, N, C], ind [B, K] -> [B, K, C]."""
    return torch.gather(feat, 1, ind[:, :, None].expand(-1, -1, feat.shape[-1]))


def gather_feat_hw(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Gather from an NHWC map at flat (y*W + x) indices: -> [B, K, C]."""
    b, h, w, c = feat.shape
    return gather_feat(feat.reshape(b, h * w, c), ind)


def topk(scores: torch.Tensor, k: int):
    """Global top-k over classes x space of [B, H, W, C].  Returns
    (scores [B,K], inds [B,K] flat y*W+x, classes [B,K], ys [B,K], xs)."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cls_scores, cls_inds = _topk_stable(flat, k)  # [B, C, K]
    top_scores, top_ind = _topk_stable(cls_scores.reshape(b, c * k), k)
    top_clses = torch.div(top_ind, k, rounding_mode="floor")
    inds = torch.gather(cls_inds.reshape(b, c * k), 1, top_ind)
    ys = torch.div(inds, w, rounding_mode="floor").float()
    xs = (inds % w).float()
    return top_scores, inds, top_clses, ys, xs


def topk_channel(scores: torch.Tensor, k: int):
    """Per-channel top-k over space of [B, H, W, C]:
    (scores [B,C,K], inds [B,C,K], ys, xs)."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    top_scores, top_inds = _topk_stable(flat, k)
    ys = torch.div(top_inds, w, rounding_mode="floor").float()
    xs = (top_inds % w).float()
    return top_scores, top_inds, ys, xs
