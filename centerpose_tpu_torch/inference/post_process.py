"""Host-side inverse affine of decoded detections, counterpart of
``centerpose_tpu/inference/post_process.py``: bbox corners and the 17 joints
go from output-grid coordinates back to original-image pixels."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from centerpose_tpu_torch.ops.image import transform_preds


def multi_pose_post_process(dets: np.ndarray, c: List[np.ndarray],
                            s: List[float], h: int,
                            w: int) -> List[Dict[int, np.ndarray]]:
    """dets [B, K, 40] (grid coords) -> per-image {1: [K, 39]} in pixels.
    Row in: bbox(4) + score(1) + joints(34) + class(1); out drops class."""
    ret = []
    for i in range(dets.shape[0]):
        bbox = transform_preds(dets[i, :, :4].reshape(-1, 2), c[i], s[i], (w, h))
        pts = transform_preds(dets[i, :, 5:39].reshape(-1, 2), c[i], s[i], (w, h))
        top_preds = np.concatenate(
            [bbox.reshape(-1, 4), dets[i, :, 4:5], pts.reshape(-1, 34)],
            axis=1).astype(np.float32)
        ret.append({1: top_preds})
    return ret
