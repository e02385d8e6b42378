"""Soft-NMS over 39-dim pose detections, counterpart of
``centerpose_tpu/ops/soft_nms.py``.

- ``soft_nms_39``: greedy pick-max with hard, linear or Gaussian score
  decay, on the host: it runs only at merge time of multi-scale testing,
  on at most K x scales rows.  It dispatches to the C++ core
  (``native/soft_nms.cpp``) when the native library is available;
  ``soft_nms_39_numpy`` is the fallback and the behavioural reference.
- ``soft_nms_39_jit``: the fixed-K Gaussian variant in torch ops on the
  tensor's own device (K rounds over a K x K IoU matrix, no host sync),
  for a merge that must stay on the device.  No path of the package calls
  it, as none of the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from centerpose_tpu_torch.native import soft_nms_39_native


def _iou_1_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one [4] box vs [N, 4] boxes (x1 y1 x2 y2)."""
    area1 = max(0.0, box[2] - box[0]) * max(0.0, box[3] - box[1])
    areas = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * np.maximum(
        0, boxes[:, 3] - boxes[:, 1])
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    iw = np.maximum(0.0, ix2 - ix1)
    ih = np.maximum(0.0, iy2 - iy1)
    inter = iw * ih
    union = area1 + areas - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def soft_nms_39(dets: np.ndarray, sigma: float = 0.5, nt: float = 0.5,
                thresh: float = 0.001, method: int = 2) -> np.ndarray:
    """Greedy soft-NMS on [N, 39] rows (bbox4 + score + 34 kps).

    method: 0 = hard NMS, 1 = linear decay, 2 = gaussian decay (the default
    for pose merging).  Returns the surviving rows (score > thresh) in pick
    order, as float32 from the C++ core; ``dets`` is not modified.
    """
    out = soft_nms_39_native(dets, sigma, nt, thresh, method)
    if out is not None:
        return out
    return soft_nms_39_numpy(dets, sigma, nt, thresh, method)


def soft_nms_39_numpy(dets: np.ndarray, sigma: float = 0.5, nt: float = 0.5,
                      thresh: float = 0.001, method: int = 2) -> np.ndarray:
    """The numpy body of ``soft_nms_39`` (the fallback)."""
    dets = dets.copy()
    n = dets.shape[0]
    keep = []
    alive = np.ones(n, bool)
    while alive.any():
        idx = np.flatnonzero(alive)
        best = idx[np.argmax(dets[idx, 4])]
        if dets[best, 4] <= thresh:
            break
        keep.append(best)
        alive[best] = False
        rest = np.flatnonzero(alive)
        if rest.size == 0:
            break
        ious = _iou_1_to_many(dets[best, :4], dets[rest, :4])
        if method == 1:  # linear
            decay = np.where(ious > nt, 1.0 - ious, 1.0)
        elif method == 2:  # gaussian
            decay = np.exp(-(ious * ious) / sigma)
        else:  # hard
            decay = (ious <= nt).astype(np.float64)
        dets[rest, 4] *= decay
        dead = rest[dets[rest, 4] <= thresh]
        alive[dead] = False
    return dets[keep]


def soft_nms_39_jit(dets: torch.Tensor, sigma: float = 0.5,
                    thresh: float = 0.001) -> torch.Tensor:
    """Fixed-K Gaussian soft-NMS on the device: [..., K, 39] -> [..., K,
    39] with column 4 decayed and nothing reordered (a suppressed row keeps
    its place with its score decayed; downstream thresholding selects).

    K rounds: each picks the best row not yet processed (ties: the first
    index, as ``argmax``) and, while its score is above ``thresh``, scales
    every other unprocessed row's score by ``exp(-iou^2 / sigma)``.
    Leading dimensions are independent batches of K rows."""
    k = dets.shape[-2]
    x1, y1, x2, y2 = dets[..., :4].unbind(-1)
    areas = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    union = areas[..., :, None] + areas[..., None, :] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    decay_mat = torch.exp(-(iou * iou) / sigma)  # [..., K, K]
    idx = torch.arange(k, device=dets.device)
    scores = dets[..., 4]
    processed = torch.zeros_like(scores, dtype=torch.bool)
    for _ in range(k):
        masked = torch.where(processed, torch.full_like(scores, -np.inf),
                             scores)
        best = masked.argmax(-1, keepdim=True)  # [..., 1]
        is_best = idx == best
        keep = is_best | processed | ~(masked.gather(-1, best) > thresh)
        row = decay_mat.gather(
            -2, best[..., None].expand(*best.shape[:-1], 1, k)).squeeze(-2)
        scores = scores * torch.where(keep, torch.ones_like(row), row)
        processed = processed | is_best
    out = dets.clone()
    out[..., 4] = scores
    return out
