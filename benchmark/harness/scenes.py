"""The hard synthetic scenes the benchmark serves and trains on: a frozen
copy of ``render_scene_hard`` and its helpers from the port's
``data/synthetic.py`` at the commit that defined the benchmark, numpy
only.  A scene is drawn from a ``numpy.random.Generator``, so one seed
gives one frame and its COCO-style annotations.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.harness import draw

# Skeleton edges of the 17 COCO keypoints (the renderers' limbs).
COCO_EDGES = [
    [0, 1], [0, 2], [1, 3], [2, 4],
    [3, 5], [4, 6], [5, 6],
    [5, 7], [7, 9], [6, 8], [8, 10],
    [5, 11], [6, 12], [11, 12],
    [11, 13], [13, 15], [12, 14], [14, 16],
]

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



def _pt(p: np.ndarray) -> Tuple[int, int]:
    """Integer pixel of a float point, truncated toward zero as
    ``astype(int)`` does (not floored: persons may start left of 0)."""
    q = p.astype(int)
    return int(q[0]), int(q[1])


def _color(rng: np.random.Generator, lo: int, hi: int) -> Tuple[int, ...]:
    return tuple(int(c) for c in rng.integers(lo, hi, 3))



_LIMB_CHAINS = (
    # (parent, child) chains articulated by the hard renderer
    (5, 7), (7, 9),      # left arm: shoulder->elbow->wrist
    (6, 8), (8, 10),     # right arm
    (11, 13), (13, 15),  # left leg: hip->knee->ankle
    (12, 14), (14, 16),  # right leg
)


def _articulate(joints: np.ndarray, rng: np.random.Generator,
                max_deg: float = 45.0) -> np.ndarray:
    """Rotate each limb segment about its parent joint by a random angle,
    propagating down the chain."""
    j = joints.copy()
    for parent, child in _LIMB_CHAINS:
        ang = np.deg2rad(rng.uniform(-max_deg, max_deg))
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s], [s, c]], np.float32)
        # rotate the child and everything downstream of it
        downstream = [child] + [cc for pp, cc in _LIMB_CHAINS if pp == child]
        pivot = j[parent]
        for d in downstream:
            j[d] = pivot + rot @ (j[d] - pivot)
    return j


def make_person_hard(rng: np.random.Generator, img_w: int,
                     img_h: int) -> Tuple[Dict, np.ndarray]:
    """Hard-mode person: log-uniform scale down to ~6% of image height,
    articulated limbs, global tilt; joints outside the frame get vis=1."""
    ph = np.exp(rng.uniform(np.log(0.06), np.log(0.62))) * img_h
    pw = ph * rng.uniform(0.3, 0.55)
    x0 = rng.uniform(-0.2 * pw, img_w - 0.8 * pw)
    y0 = rng.uniform(-0.2 * ph, img_h - 0.8 * ph)
    joints = _CANON.copy()
    joints[:, 0] = joints[:, 0] * pw
    joints[:, 1] = joints[:, 1] * ph
    joints = _articulate(joints, rng)
    ang = np.deg2rad(rng.uniform(-25, 25))
    c, s = np.cos(ang), np.sin(ang)
    ctr = joints.mean(0)
    joints = (joints - ctr) @ np.array([[c, s], [-s, c]], np.float32) + ctr
    joints[:, 0] += x0 + rng.normal(0, 0.015 * pw, 17)
    joints[:, 1] += y0 + rng.normal(0, 0.015 * ph, 17)
    xs, ys = joints[:, 0], joints[:, 1]
    bx0, by0 = float(xs.min()), float(ys.min())
    bw, bh = float(xs.max() - bx0), float(ys.max() - by0)
    vis = np.full(17, 2, np.int32)
    inside = ((xs >= 0) & (xs < img_w) & (ys >= 0) & (ys < img_h))
    vis[~inside] = 1  # labeled, outside the frame
    kp = []
    for j in range(17):
        kp += [float(joints[j, 0]), float(joints[j, 1]), int(vis[j])]
    ann = {
        "bbox": [bx0, by0, bw, bh],
        "keypoints": kp,
        "area": bw * bh,
        "iscrowd": 0,
        "category_id": 1,
    }
    return ann, joints


def render_scene_hard(rng: np.random.Generator, img_w: int = 640,
                      img_h: int = 480,
                      n_people: int = 6) -> Tuple[np.ndarray, List[Dict]]:
    """Hard benchmark scene: heavy crowding (overlap allowed), log-uniform
    scale down to tiny persons, articulated poses, low-contrast colours,
    skeleton-like background clutter, and occluder patches that flip the
    joints they cover to vis=1.  A converged flagship lands mid-range AP
    here, so accuracy differences of a few thousandths are resolvable."""
    img = np.full((img_h, img_w, 3), 40, np.uint8)
    noise = rng.integers(0, 70, (img_h // 4, img_w // 4, 3), dtype=np.uint8)
    img += draw.resize_nearest(noise, (img_w, img_h))

    # skeleton-like clutter: limb-coloured segments and small discs
    for _ in range(int(rng.integers(6, 16))):
        p = rng.uniform([0, 0], [img_w, img_h]).astype(int)
        q = (p + rng.normal(0, 40, 2)).astype(int)
        color = _color(rng, 70, 255)
        draw.line(img, _pt(p), _pt(q), color,
                  thickness=int(rng.integers(1, 4)))
    for _ in range(int(rng.integers(3, 9))):
        p = rng.uniform([0, 0], [img_w, img_h]).astype(int)
        draw.circle_filled(img, _pt(p), int(rng.integers(2, 7)),
                           _color(rng, 120, 255))

    anns: List[Dict] = []
    all_joints: List[np.ndarray] = []
    order = []
    for _ in range(n_people):
        ann, joints = make_person_hard(rng, img_w, img_h)
        order.append((ann["bbox"][3], ann, joints))  # draw big->small
    order.sort(key=lambda t: -t[0])
    for _, ann, joints in order:
        color = _color(rng, 70, 255)
        th = max(1, int(ann["bbox"][3] / 45))
        for a, b in COCO_EDGES:
            draw.line(img, _pt(joints[a]), _pt(joints[b]), color, thickness=th)
        draw.circle_filled(img, _pt(joints[0]),
                           max(2, int(ann["bbox"][3] / 18)), color)
        for j in range(17):
            draw.circle_filled(img, _pt(joints[j]), max(1, th // 2),
                               (255, 255, 255))
        anns.append(ann)
        all_joints.append(joints)

    # occluder patches over the rendered people; covered joints -> vis=1
    for _ in range(int(rng.integers(1, 5))):
        ow = int(rng.uniform(0.05, 0.22) * img_w)
        oh = int(rng.uniform(0.05, 0.22) * img_h)
        ox = int(rng.uniform(0, img_w - ow))
        oy = int(rng.uniform(0, img_h - oh))
        color = _color(rng, 20, 110)
        draw.rectangle_filled(img, (ox, oy), (ox + ow, oy + oh), color)
        for ann, joints in zip(anns, all_joints):
            kp = ann["keypoints"]
            for j in range(17):
                jx, jy = joints[j]
                if (ox <= jx < ox + ow and oy <= jy < oy + oh
                        and kp[3 * j + 2] == 2):
                    kp[3 * j + 2] = 1
    return img, anns
