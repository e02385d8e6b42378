"""Synthetic persons with exact keypoint annotations.

Counterpart of ``make_person`` in ``centerpose_tpu/data/synthetic.py``
(numpy only; the scene renderers there draw with cv2 and are not ported
yet): a randomly placed, scaled and jittered 17-joint skeleton in COCO
annotation format, so that it flows through the same encode path as real
data.  Bit-exact with the JAX package's for the same generator stream.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Canonical upright skeleton in a unit box (x, y in [0, 1]), COCO joint order.
_CANON = np.array(
    [
        [0.50, 0.08],  # nose
        [0.46, 0.05], [0.54, 0.05],  # eyes
        [0.42, 0.08], [0.58, 0.08],  # ears
        [0.35, 0.22], [0.65, 0.22],  # shoulders
        [0.28, 0.40], [0.72, 0.40],  # elbows
        [0.22, 0.55], [0.78, 0.55],  # wrists
        [0.40, 0.55], [0.60, 0.55],  # hips
        [0.38, 0.75], [0.62, 0.75],  # knees
        [0.36, 0.95], [0.64, 0.95],  # ankles
    ],
    dtype=np.float32,
)


def make_person(rng: np.random.Generator, img_w: int,
                img_h: int) -> Tuple[Dict, np.ndarray]:
    """Random placed/scaled/jittered person; returns (coco_ann, joints [17,2])."""
    ph = rng.uniform(0.25, 0.7) * img_h
    pw = ph * rng.uniform(0.35, 0.5)
    x0 = rng.uniform(0, max(1.0, img_w - pw))
    y0 = rng.uniform(0, max(1.0, img_h - ph))
    joints = _CANON.copy()
    joints[:, 0] = x0 + joints[:, 0] * pw + rng.normal(0, 0.01 * pw, 17)
    joints[:, 1] = y0 + joints[:, 1] * ph + rng.normal(0, 0.01 * ph, 17)
    kp = []
    for j in range(17):
        kp += [float(joints[j, 0]), float(joints[j, 1]), 2]
    ann = {
        "bbox": [x0, y0, pw, ph],
        "keypoints": kp,
        "area": pw * ph,
        "iscrowd": 0,
        "category_id": 1,
    }
    return ann, joints
