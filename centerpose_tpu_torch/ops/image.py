"""Image geometry: the crop affine, its inverse on predictions, and the
warp the detector's pre-process applies.

Counterpart of the geometry part of ``centerpose_tpu/ops/image.py``
(``get_affine_transform``, ``affine_transform``, ``transform_preds``,
``FLIP_IDX``), numpy on the host.  ``warp_affine`` replaces the
``cv2.warpAffine`` call of the JAX detector with tensor ops on the device:
bilinear sampling with a zero border, from the same 2x3 matrix.
"""

from __future__ import annotations

import numpy as np
import torch

# Left/right joint pairs of the 17 COCO keypoints.
FLIP_IDX = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]


def _get_dir(src_point: np.ndarray, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [src_point[0] * cs - src_point[1] * sn, src_point[0] * sn + src_point[1] * cs],
        dtype=np.float32,
    )


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def get_affine_transform(
    center,
    scale,
    rot: float,
    output_size,
    shift=(0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """2x3 affine mapping the (center, scale, rot) crop to ``output_size``.

    ``scale`` is a scalar (side length of the square source crop in source
    pixels) or an ``(w, h)`` pair.  ``shift`` is a fractional translation of
    the crop.  ``inv=True`` returns the inverse map (dst -> src), used by
    ``transform_preds``.
    """
    center = np.asarray(center, dtype=np.float32)
    if not isinstance(scale, (list, tuple, np.ndarray)):
        scale = np.array([scale, scale], dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    src_w = scale[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _get_dir(np.array([0.0, src_w * -0.5], np.float32), rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale * shift
    src[1, :] = center + src_dir + scale * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2, :] = _get_3rd_point(src[0, :], src[1, :])
    dst[2, :] = _get_3rd_point(dst[0, :], dst[1, :])

    # Solve the 6-dof affine from 3 point pairs (replaces cv2.getAffineTransform
    # so the pure-numpy path has no cv2 dependency).
    if inv:
        src, dst = dst, src
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros((6,), dtype=np.float64)
    for i in range(3):
        a[2 * i, 0:2] = src[i]
        a[2 * i, 2] = 1.0
        a[2 * i + 1, 3:5] = src[i]
        a[2 * i + 1, 5] = 1.0
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    sol = np.linalg.solve(a, b)
    return sol.reshape(2, 3).astype(np.float32)


def affine_transform(pt, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to a single (x, y) point."""
    new_pt = np.array([pt[0], pt[1], 1.0], dtype=np.float32)
    return (t @ new_pt)[:2]


def affine_transform_batch(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to an [N, 2] array of points."""
    pts = np.asarray(pts, dtype=np.float32)
    ones = np.ones((pts.shape[0], 1), dtype=np.float32)
    return np.concatenate([pts, ones], axis=1) @ t.T


def transform_preds(coords: np.ndarray, center, scale, output_size) -> np.ndarray:
    """Map predicted output-grid coords back to original image pixels.

    Reference: lib/utils/image.py transform_preds — builds the inverse affine
    of (center, scale, 0, output_size) and applies it per point.
    """
    t = get_affine_transform(center, scale, 0.0, output_size, inv=True)
    return affine_transform_batch(coords.reshape(-1, 2), t).reshape(coords.shape)


def warp_affine(image: torch.Tensor, trans: np.ndarray, out_size) -> torch.Tensor:
    """Warp an [H, W, C] image (any dtype, any device) by the 2x3 affine
    ``trans`` (source pixel -> destination pixel) into ``out_size = (w, h)``:
    each destination pixel samples the source bilinearly at the inverse-mapped
    point, with zero outside the image (``cv2.warpAffine`` with
    ``INTER_LINEAR`` and a constant 0 border, computed in float32 rather
    than cv2's 1/32-pixel fixed point).  Returns float32 [h, w, C]."""
    out_w, out_h = int(out_size[0]), int(out_size[1])
    h, w, c = image.shape
    m = np.vstack([np.asarray(trans, np.float64), [0.0, 0.0, 1.0]])
    inv = torch.tensor(np.linalg.inv(m)[:2], dtype=torch.float32,
                       device=image.device)
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=image.device),
        torch.arange(out_w, dtype=torch.float32, device=image.device),
        indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx1 = sx - x0
    wy1 = sy - y0
    src = image.reshape(h * w, c).float()
    out = torch.zeros((out_h * out_w, c), dtype=torch.float32,
                      device=image.device)
    for cy, cx, wgt in ((0, 0, (1 - wy1) * (1 - wx1)), (0, 1, (1 - wy1) * wx1),
                        (1, 0, wy1 * (1 - wx1)), (1, 1, wy1 * wx1)):
        yc = y0 + cy
        xc = x0 + cx
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long().reshape(-1)
        out += src[idx] * (wgt * valid.float()).reshape(-1, 1)
    return out.reshape(out_h, out_w, c)
