"""cv2-free raster drawing: a frozen copy of the port's ``data/draw.py``
at the commit that defined the benchmark, so that the frames a seed
renders stay the same whatever later changes make to the program.

It is bit-exact with OpenCV's 8-connected primitives (``resize_nearest``,
``rectangle_filled``, ``circle_filled``, ``line``) on a uint8 [H, W, C]
image, following OpenCV's integer arithmetic step by step.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on an image of ``width`` x ``height`` (pixels,
    or fixed-point units for ``Line2``).  Returns (inside, x1, y1, x2, y2)."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _put_points(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _fill_spans(img: np.ndarray, y0: int, xl: np.ndarray, xr: np.ndarray,
                color) -> None:
    """Fill rows ``y0 + i`` from ``xl[i]`` to ``xr[i]`` inclusive, clipped
    to the image (rows outside it and empty spans are skipped)."""
    h, w = img.shape[:2]
    ys = y0 + np.arange(len(xl))
    xl = np.maximum(xl, 0)
    xr = np.minimum(xr, w - 1)
    ok = (ys >= 0) & (ys < h) & (xl <= xr)
    if not ok.any():
        return
    ys, xl, xr = ys[ok], xl[ok], xr[ok]
    c0, c1 = int(xl.min()), int(xr.max())
    r0, r1 = int(ys[0]), int(ys[-1])
    cols = np.arange(c0, c1 + 1)
    mask = np.zeros((r1 - r0 + 1, c1 - c0 + 1), bool)
    mask[ys - r0] = (cols >= xl[:, None]) & (cols <= xr[:, None])
    img[r0:r1 + 1, c0:c1 + 1][mask] = color


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's ``Line`` at connectivity 8 (integer endpoints)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # Bresenham: step k moves the minor axis after k steps
    # ceil((2k*dy - dx) / (2dx)) times (err = dx - 2dy, +2dx on a move)
    k = np.arange(dx + 1, dtype=np.int64)
    minor = -((dx - 2 * k * dy) // (2 * dx)) if dx > 0 else k
    if vert:
        xs, ys = x1 + minor, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * minor
    img[ys, xs] = color


def _line2(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between fixed-point
    (``XY_SHIFT``) endpoints, as ``FillConvexPoly`` draws its outline."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                        x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    _put_points(img, np.array([(x2 + _HALF) >> XY_SHIFT]),
                np.array([(y2 + _HALF) >> XY_SHIFT]), color)
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    _put_points(img, xs, ys, color)


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color,
                      shift: int) -> None:
    """OpenCV's ``FillConvexPoly`` at ``LINE_8`` on vertices ``v`` in fixed
    point with ``shift`` fractional bits: the outline (``Line`` at shift 0,
    ``Line2`` otherwise), then the scanlines between the two edge chains
    that start at the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    up = XY_SHIFT - shift
    px, py = v[-1][0] << up, v[-1][1] << up
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax = max(ymax, y)
        xmax = max(xmax, x)
        xmin = min(xmin, x)
        qx, qy = x << up, y << up
        if shift == 0:
            _line8(img, px >> XY_SHIFT, py >> XY_SHIFT, qx >> XY_SHIFT,
                   qy >> XY_SHIFT, color)
        else:
            _line2(img, px, py, qx, qy, color)
        px, py = qx, qy
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)

    # two edge walkers: (idx, di, x, dx, ye); the scan runs segment by
    # segment, each a run of scanlines with both edges linear in y
    idx_ = [imin, imin]
    di_ = [1, npts - 1]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    ye = [ymin, ymin]
    edges = npts
    y = ymin
    while True:
        for i in (0, 1):
            if y >= ye[i]:
                idx0, di = idx_[i], di_[i]
                idx = (idx0 + di) % npts
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << up
                        xe = v[idx][0] << up
                        ye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        ex[i] = xs
                        idx_[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        y_end = min(ye[0], ye[1], ymax + 1)
        k = np.arange(y_end - y, dtype=np.int64)
        xa = ex[0] + k * edx[0]
        xb = ex[1] + k * edx[1]
        _fill_spans(img, y, (np.minimum(xa, xb) + _HALF) >> XY_SHIFT,
                    (np.maximum(xa, xb) + _HALF) >> XY_SHIFT, color)
        ex[0] += (y_end - y) * edx[0]
        ex[1] += (y_end - y) * edx[1]
        y = y_end
        if y > ymax:
            break


@functools.lru_cache(maxsize=64)
def _circle_half_widths(radius: int) -> np.ndarray:
    """Half-width of OpenCV's filled ``Circle`` at each |row offset|
    0..radius (-1: no span), from its midpoint iteration."""
    hw = np.full(radius + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        hw[dy] = max(hw[dy], dx)
        hw[dx] = max(hw[dx], dy)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    hw.flags.writeable = False
    return hw


def circle_filled(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` in place."""
    cx, cy = int(center[0]), int(center[1])
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    hw = _circle_half_widths(radius)
    offs = np.arange(-radius, radius + 1)
    half = hw[np.abs(offs)]
    _fill_spans(img, cy - radius, cx - half, cx + half, color)
    return img


def rectangle_filled(img: np.ndarray, p, q, color) -> np.ndarray:
    """``cv2.rectangle(img, p, q, color, -1)`` in place (inclusive
    corners, clipped)."""
    x1, y1, x2, y2 = int(p[0]), int(p[1]), int(q[0]), int(q[1])
    _fill_convex_poly(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], color, 0)
    return img


def line(img: np.ndarray, p, q, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p, q, color, thickness)`` at ``LINE_8`` in place."""
    x1, y1, x2, y2 = int(p[0]), int(p[1]), int(q[0]), int(q[1])
    thickness = int(thickness)
    if thickness < 1:
        raise ValueError(f"thickness {thickness} < 1")
    if thickness == 1:
        _line8(img, x1, y1, x2, y2, color)
        return img
    # the segment is first clipped to the image grown by the thickness on
    # every side (end discs outside that cannot reach the image)
    h, w = img.shape[:2]
    t = thickness
    inside, x1, y1, x2, y2 = _clip_line(w + 2 * t, h + 2 * t, x1 + t, y1 + t,
                                        x2 + t, y2 + t)
    if not inside:
        return img
    x1, y1, x2, y2 = x1 - t, y1 - t, x2 - t, y2 - t
    # ThickLine in 16-bit fixed point: half the thickness is t * 2^15, and
    # the offset to the quadrilateral's sides is cvRound(d * r) with
    # r = (t * 2^15 + odd * 2^15) / |d|
    half = t << (XY_SHIFT - 1)
    ddx = float(x1 - x2)
    ddy = float(y2 - y1)
    r = ddx * ddx + ddy * ddy
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (t & 1) * XY_ONE * 0.5) / np.sqrt(r)
        ox = int(np.rint(ddy * r))
        oy = int(np.rint(ddx * r))
        x1f, y1f, x2f, y2f = (c << XY_SHIFT for c in (x1, y1, x2, y2))
        _fill_convex_poly(img, [(x1f + ox, y1f + oy), (x1f - ox, y1f - oy),
                                (x2f - ox, y2f - oy), (x2f + ox, y2f + oy)],
                          color, XY_SHIFT)
    cap = (half + _HALF) >> XY_SHIFT
    circle_filled(img, (x1, y1), cap, color)
    circle_filled(img, (x2, y2), cap, color)
    return img


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)`` for a
    ``size = (w, h)`` that is an exact integer multiple of the image's."""
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if h % sh or w % sw:
        raise ValueError(f"{sw}x{sh} -> {w}x{h} is not an integer upscale")
    return np.repeat(np.repeat(img, h // sh, axis=0), w // sw, axis=1)
