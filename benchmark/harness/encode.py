"""The training cell's batches: hard scenes encoded into the supervision
the train step consumes, on the compact wire, in numpy.

A frozen copy of the port's host encoder (``data/encode.encode_example``
with its ``ops/image`` helpers, the Python fill loop, ``loss.dense_hp``
off) at the commit that defined the benchmark, with one change: the
affine warp is a plain bilinear sampler (``grid_sample``) with a zero
border, not the port's bit-exact copy of ``cv2.warpAffine``.  The batches are the
benchmark's own inputs, so they need no native build and no likeness to
any other encoder's bytes.

Per example: random scale, shift and flip, the warp to ``input_res``, the
colour augmentation as six coefficients that the device replays (``aug``:
brightness, contrast and saturation folded into ``A x + c_gs gs + c_mean
mean(gs)``, plus the PCA lighting shift), and the stride-4 targets: the
centre gaussian ``hm``, joint gaussians ``hm_hp`` (CornerNet radius at
min_overlap 0.7), ``wh``, ``reg``, ``hps``, ``hp_offset`` at sparse
``ind`` / ``hp_ind`` with their masks, ``max_objs`` objects.  Heatmaps
ride as float16, the image as the pre-augmentation uint8 warp.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

FLIP_IDX = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
            [15, 16]]
_EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], dtype=np.float32)
_EIG_VEC = np.array([[-0.58752847, -0.69563484, 0.41340352],
                     [-0.5832747, 0.00994535, -0.81221408],
                     [-0.56089297, 0.71832671, 0.41158938]],
                    dtype=np.float32)


def get_affine_transform(center, scale: float, output_size) -> np.ndarray:
    """2x3 affine mapping the square crop of side ``scale`` about
    ``center`` onto ``output_size`` (no rotation, no shift)."""
    center = np.asarray(center, dtype=np.float32)
    src_w = np.float32(scale)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center
    src[1] = center + np.array([0.0, src_w * -0.5], np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5 - dst_w * 0.5], np.float32)
    for pts in (src, dst):
        d = pts[0] - pts[1]
        pts[2] = pts[1] + np.array([-d[1], d[0]], dtype=np.float32)
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros((6,), dtype=np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1.0
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    return np.linalg.solve(a, b).reshape(2, 3).astype(np.float32)


def affine_transform_batch(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    pts = np.asarray(pts, dtype=np.float32)
    ones = np.ones((pts.shape[0], 1), dtype=np.float32)
    return np.concatenate([pts, ones], axis=1) @ t.T


def warp(img: np.ndarray, t: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC ``img`` warped by the 2x3 ``t`` onto size x size:
    bilinear, zero outside the source, rounded to uint8 (``grid_sample``
    on the host)."""
    inv = np.linalg.inv(np.vstack([t, [0, 0, 1]]).astype(np.float64))[:2]
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    h, w = img.shape[:2]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    grid = np.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    src = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)
    out = F.grid_sample(src[None].float(),
                        torch.from_numpy(grid[None]).float(),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)[0]
    return out.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0) \
        .numpy()


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet's radius: the least of its three quadratic cases."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1.0 - min_overlap) / (1.0 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2.0
    b2 = 2.0 * (height + width)
    c2 = (1.0 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * c2)) / 2.0
    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (height + width)
    c3 = (min_overlap - 1.0) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2.0
    return min(r1, r2, r3)


def draw_gaussian(heatmap: np.ndarray, center, radius: int) -> None:
    """Max-composite a gaussian (sigma = diameter / 6) at integer
    ``center`` into the 2-D ``heatmap``."""
    d = 2 * radius + 1
    m = (d - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    g = np.exp(-(x * x + y * y) / (2.0 * (d / 6.0) ** 2))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    cx, cy = int(center[0]), int(center[1])
    h, w = heatmap.shape
    left, right = min(cx, radius), min(w - cx, radius + 1)
    top, bottom = min(cy, radius), min(h - cy, radius + 1)
    hm = heatmap[cy - top:cy + bottom, cx - left:cx + right]
    gg = g[radius - top:radius + bottom, radius - left:radius + right]
    if min(gg.shape) > 0 and min(hm.shape) > 0:
        np.maximum(hm, gg, out=hm)


def color_aug_coeffs(rng: np.random.Generator) -> np.ndarray:
    """[A, c_gs, c_mean, pca_r, pca_g, pca_b]: brightness, contrast and
    saturation (strength 0.4, in a shuffled order) folded into one affine
    map of the image, its greyscale and the greyscale's mean, then the PCA
    lighting shift (alpha 0.1)."""
    order = [0, 1, 2]
    rng.shuffle(order)
    a_tot, c_gs, c_mean = 1.0, 0.0, 0.0
    for op in order:
        a = 1.0 + rng.uniform(-0.4, 0.4)
        a_tot *= a
        c_gs *= a
        c_mean *= a
        if op == 1:
            c_mean += 1.0 - a
        elif op == 2:
            c_gs += 1.0 - a
    alpha = rng.normal(scale=0.1, size=(3,)).astype(np.float32)
    pca = _EIG_VEC @ (_EIG_VAL * alpha)
    return np.concatenate([np.array([a_tot, c_gs, c_mean], np.float32),
                           pca.astype(np.float32)])


def encode(img: np.ndarray, anns: list, rng: np.random.Generator,
           in_res: int = 512, max_objs: int = 32, scale: float = 0.4,
           shift: float = 0.1, flip: float = 0.5) -> Dict[str, np.ndarray]:
    """One train-augmented example on the compact wire."""
    height, width = img.shape[:2]
    out_res = in_res // 4
    nj = 17
    c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
    s = float(max(height, width))
    c[0] += s * np.clip(rng.standard_normal() * shift, -2 * shift, 2 * shift)
    c[1] += s * np.clip(rng.standard_normal() * shift, -2 * shift, 2 * shift)
    s = s * float(np.clip(rng.standard_normal() * scale + 1.0, 1 - scale,
                          1 + scale))
    flipped = rng.random() < flip
    if flipped:
        img = img[:, ::-1, :]
        c[0] = width - c[0] - 1
    inp = warp(img, get_affine_transform(c, s, (in_res, in_res)), in_res)
    aug = color_aug_coeffs(rng)
    t_out = get_affine_transform(c, s, (out_res, out_res))

    hm = np.zeros((out_res, out_res, 1), dtype=np.float32)
    hm_hp = np.zeros((out_res, out_res, nj), dtype=np.float32)
    wh = np.zeros((max_objs, 2), dtype=np.float32)
    hps = np.zeros((max_objs, nj * 2), dtype=np.float32)
    reg = np.zeros((max_objs, 2), dtype=np.float32)
    ind = np.zeros((max_objs,), dtype=np.int32)
    reg_mask = np.zeros((max_objs,), dtype=np.float32)
    hps_mask = np.zeros((max_objs, nj * 2), dtype=np.float32)
    hp_offset = np.zeros((max_objs * nj, 2), dtype=np.float32)
    hp_ind = np.zeros((max_objs * nj,), dtype=np.int32)
    hp_mask = np.zeros((max_objs * nj,), dtype=np.float32)
    for k, ann in enumerate(anns[:max_objs]):
        x, y, w, h = [float(v) for v in ann["bbox"]]
        bbox = np.array([x, y, x + w, y + h], dtype=np.float32)
        pts = np.array(ann["keypoints"], np.float32).reshape(nj, 3)
        if flipped:
            bbox[[0, 2]] = width - bbox[[2, 0]] - 1
            pts[:, 0] = width - pts[:, 0] - 1
            for a, b in FLIP_IDX:
                pts[[a, b]] = pts[[b, a]]
        bbox = np.clip(affine_transform_batch(bbox.reshape(2, 2),
                                              t_out).reshape(4),
                       0, out_res - 1)
        bh, bw = bbox[3] - bbox[1], bbox[2] - bbox[0]
        if bh <= 0 or bw <= 0:
            continue
        radius = max(0, int(gaussian_radius((math.ceil(bh),
                                             math.ceil(bw)))))
        ct = np.array([(bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0],
                      dtype=np.float32)
        ct_int = ct.astype(np.int32)
        wh[k] = bw, bh
        ind[k] = ct_int[1] * out_res + ct_int[0]
        reg[k] = ct - ct_int
        reg_mask[k] = 1.0
        if (pts[:, 2] > 0).sum() == 0:
            hm[ct_int[1], ct_int[0], 0] = 0.9999
            reg_mask[k] = 0.0
        for j in range(nj):
            if pts[j, 2] > 0:
                pj = affine_transform_batch(pts[j:j + 1, :2], t_out)[0]
                if 0 <= pj[0] < out_res and 0 <= pj[1] < out_res:
                    hps[k, j * 2:j * 2 + 2] = pj - ct_int
                    hps_mask[k, j * 2:j * 2 + 2] = 1.0
                    pj_int = pj.astype(np.int32)
                    hp_offset[k * nj + j] = pj - pj_int
                    hp_ind[k * nj + j] = pj_int[1] * out_res + pj_int[0]
                    hp_mask[k * nj + j] = 1.0
                    draw_gaussian(hm_hp[:, :, j], pj_int, radius)
        draw_gaussian(hm[:, :, 0], ct_int, radius)
    return {"input": inp, "hm": hm.astype(np.float16),
            "hm_hp": hm_hp.astype(np.float16), "wh": wh, "aug": aug,
            "hps": hps, "reg": reg, "ind": ind, "reg_mask": reg_mask,
            "hps_mask": hps_mask, "hp_offset": hp_offset, "hp_ind": hp_ind,
            "hp_mask": hp_mask}


def stack(examples: list) -> Dict[str, np.ndarray]:
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
