"""COCO person-keypoint data, counterpart of ``centerpose_tpu/data/coco.py``.

So far only the conversion of detections to COCO result dicts, which the
synthetic evaluation split calls; reading COCO annotation files comes with
the dataset reader.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def convert_eval_format(results: Dict[int, Dict[int, np.ndarray]]) -> List[dict]:
    """{image_id: {1: [N, 39]}} -> COCO detection dicts.

    Row layout: bbox (x1, y1, x2, y2) + score + 17 joints (x, y); the box
    becomes xywh and the joints 17 x [x, y, 1], rounded to 2 decimals.
    """
    dets = []
    for img_id, by_cat in results.items():
        for row in np.asarray(by_cat[1]):
            x1, y1, x2, y2, score = [float(v) for v in row[:5]]
            kps = np.asarray(row[5:39], np.float64).reshape(17, 2)
            kp_out = np.concatenate([kps, np.ones((17, 1))], axis=1).reshape(-1)
            dets.append({
                "image_id": int(img_id),
                "category_id": 1,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": score,
                "keypoints": [round(float(v), 2) for v in kp_out],
            })
    return dets
