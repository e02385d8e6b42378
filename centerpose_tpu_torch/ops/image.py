"""Image geometry, gaussian target splatting and photometric augmentation.

Counterpart of ``centerpose_tpu/ops/image.py``: the crop affine, its
inverse on predictions (``get_affine_transform``, ``affine_transform``,
``transform_preds``, ``FLIP_IDX``, ``flip_joints``), the CornerNet
gaussians of the training targets (``gaussian_radius``, ``gaussian2d``,
``draw_umich_gaussian``, ``draw_dense_reg``) and the colour augmentation
(``color_aug``, ``color_aug_coeffs``, ``COLOR_AUG_IDENTITY``), numpy on the
host and copied so that they stay bit-exact given the same
``np.random.Generator`` stream.  ``warp_affine`` and ``resize_linear``
replace the ``cv2.warpAffine`` and ``cv2.resize`` calls of the JAX package
with tensor ops on the device: bilinear sampling with a zero border from
the same 2x3 matrix (within one uint8 level of cv2), and bilinear resizing
(bit-equal to cv2 on uint8 images).
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


_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, clamp: bool):
    """Source indices i0, i1 and float32 weight f of i1 along one axis of
    ``cv2.resize``'s INTER_LINEAR: half-pixel centres,
    ``f = float32((x + 0.5) * src / dst - 0.5)`` less its floor.  Outside
    the image the indices are clamped to the edge; ``clamp`` also zeroes f
    there (cv2 does so along x, not along y)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp:
        f[(i0 < 0) | (i0 >= src - 1)] = 0.0
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), f


def resize_linear(image: torch.Tensor, size) -> torch.Tensor:
    """Resize an [H, W, C] image (any device) to ``size = (w, h)`` as
    ``cv2.resize(image, size)`` does (INTER_LINEAR: half-pixel centres, no
    antialias, edge pixels replicated).  A uint8 image follows cv2's 11-bit
    fixed point as its vectorised path rounds it (rows by int32
    multiply-adds, columns by 16-bit high products), and comes back as
    uint8; any other dtype is resampled in float32.  The same size returns
    the image itself: no resampling."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w, _ = image.shape
    if (out_w, out_h) == (w, h):
        return image
    dev = image.device
    x0, x1, fx = _linear_taps(w, out_w, clamp=True)
    y0, y1, fy = _linear_taps(h, out_h, clamp=False)
    x0, x1, y0, y1 = (torch.from_numpy(a).to(dev) for a in (x0, x1, y0, y1))
    if image.dtype == torch.uint8:
        one = np.float32(1 << _COEF_BITS)

        def coef(f):
            return [torch.from_numpy(np.rint(c * one).astype(np.int32)).to(dev)
                    for c in (np.float32(1) - f, f)]

        a0, a1 = (c[None, :, None] for c in coef(fx))
        b0, b1 = (c[:, None, None] for c in coef(fy))
        src = image.to(torch.int32)
        rows = src[:, x0] * a0 + src[:, x1] * a1
        top = ((rows[y0] >> 4).clamp_(-32768, 32767) * b0) >> 16
        bot = ((rows[y1] >> 4).clamp_(-32768, 32767) * b1) >> 16
        return ((top + bot + 2) >> 2).clamp_(0, 255).to(torch.uint8)
    fx = torch.from_numpy(fx).to(dev)[None, :, None]
    fy = torch.from_numpy(fy).to(dev)[:, None, None]
    src = image.float()
    rows = src[:, x0] * (1 - fx) + src[:, x1] * fx
    return rows[y0] * (1 - fy) + rows[y1] * fy


# ---------------------------------------------------------------------------
# Gaussian target splatting (CornerNet-style)
# ---------------------------------------------------------------------------


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet 3-case quadratic radius so a shifted box keeps IoU >= min_overlap.

    """
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1.0 - min_overlap) / (1.0 + min_overlap)
    sq1 = np.sqrt(b1 ** 2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2.0

    a2 = 4.0
    b2 = 2.0 * (height + width)
    c2 = (1.0 - min_overlap) * width * height
    sq2 = np.sqrt(b2 ** 2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2.0

    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (height + width)
    c3 = (min_overlap - 1.0) * width * height
    sq3 = np.sqrt(b3 ** 2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2.0
    return min(r1, r2, r3)


def gaussian2d(shape, sigma: float = 1.0) -> np.ndarray:
    """Unnormalized 2D gaussian patch of the given (odd) shape."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_umich_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> np.ndarray:
    """Max-composite a gaussian of the given integer radius at integer ``center``.

    In-place on ``heatmap`` (2D).  sigma = diameter / 6 as in the reference.
    """
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6.0)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[
        radius - top : radius + bottom, radius - left : radius + right
    ]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def draw_dense_reg(
    regmap: np.ndarray,
    heatmap: np.ndarray,
    center,
    value,
    radius: int,
    is_offset: bool = False,
) -> np.ndarray:
    """Dense regression target splat (reference draw_dense_reg; for DENSE_HP)."""
    diameter = 2 * radius + 1
    gaussian = gaussian2d((diameter, diameter), sigma=diameter / 6.0)
    value = np.asarray(value, dtype=np.float32).reshape(-1, 1, 1)
    dim = value.shape[0]
    reg = np.ones((dim, diameter, diameter), dtype=np.float32) * value
    if is_offset and dim == 2:
        delta = np.arange(diameter) - radius
        reg[0] = reg[0] - delta.reshape(1, -1)
        reg[1] = reg[1] - delta.reshape(-1, 1)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top : y + bottom, x - left : x + right]
    masked_regmap = regmap[:, y - top : y + bottom, x - left : x + right]
    masked_gaussian = gaussian[
        radius - top : radius + bottom, radius - left : radius + right
    ]
    masked_reg = reg[:, radius - top : radius + bottom, radius - left : radius + right]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        idx = (masked_gaussian >= masked_heatmap).reshape(1, *masked_gaussian.shape)
        masked_regmap = (1 - idx) * masked_regmap + idx * masked_reg
    regmap[:, y - top : y + bottom, x - left : x + right] = masked_regmap
    return regmap


# ---------------------------------------------------------------------------
# Photometric augmentation (PCA lighting + brightness/contrast/saturation)
# ---------------------------------------------------------------------------

# COCO eigen decomposition used by the reference (lib/utils/image.py).
_EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], dtype=np.float32)
_EIG_VEC = np.array(
    [
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938],
    ],
    dtype=np.float32,
)


def _grayscale(image: np.ndarray) -> np.ndarray:
    return image @ np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _blend(alpha: float, image1: np.ndarray, image2: np.ndarray) -> np.ndarray:
    image1 *= alpha
    image1 += (1.0 - alpha) * image2
    return image1


def color_aug(rng: np.random.Generator, image: np.ndarray) -> np.ndarray:
    """In-place photometric aug on a float image in [0, 1], RGB.

    Order matches the reference: random shuffle of (brightness, contrast,
    saturation) each with strength 0.4, then PCA lighting noise (alpha 0.1).
    """
    gs = _grayscale(image)
    gs_mean = gs.mean()

    def brightness(img):
        return _blend(1.0 + rng.uniform(-0.4, 0.4), img, 0.0)

    def contrast(img):
        return _blend(1.0 + rng.uniform(-0.4, 0.4), img, gs_mean)

    def saturation(img):
        return _blend(1.0 + rng.uniform(-0.4, 0.4), img, gs[..., None])

    fns = [brightness, contrast, saturation]
    rng.shuffle(fns)
    for f in fns:
        image = f(image)

    # PCA lighting
    alpha = rng.normal(scale=0.1, size=(3,)).astype(np.float32)
    image += _EIG_VEC @ (_EIG_VAL * alpha)
    return image


def color_aug_coeffs(rng: np.random.Generator) -> np.ndarray:
    """Sample ``color_aug`` as 6 affine coefficients for device-side replay.

    Because ``gs``/``gs_mean`` are computed ONCE from the pre-aug image, the
    shuffled brightness/contrast/saturation chain composes into
    ``img' = A*img + c_gs*gs[..,None] + c_mean*gs_mean + pca`` — so the
    compact wire (train.wire) ships the un-augmented uint8 warp plus these
    [A, c_gs, c_mean, pca_r, pca_g, pca_b] floats and the jitted step
    replays the EXACT host augmentation (same rng stream: shuffle, then one
    uniform per op in execution order, then the PCA normal — matching
    ``color_aug`` draw for draw)."""
    order = [0, 1, 2]  # brightness, contrast, saturation
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
    return np.concatenate(
        [np.array([a_tot, c_gs, c_mean], np.float32), pca.astype(np.float32)]
    )


# identity color aug (A=1, no gs/mean/PCA terms) for non-augmented samples
COLOR_AUG_IDENTITY = np.array([1, 0, 0, 0, 0, 0], np.float32)


def flip_joints(pts: np.ndarray, width: float) -> np.ndarray:
    """Horizontally flip [..., J, >=2] joint coords and swap L/R joints."""
    pts = pts.copy()
    pts[..., 0] = width - pts[..., 0] - 1
    for a, b in FLIP_IDX:
        tmp = pts[..., a, :].copy()
        pts[..., a, :] = pts[..., b, :]
        pts[..., b, :] = tmp
    return pts
