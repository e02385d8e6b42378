"""The port's cv2-free drawing (``data/draw.py``) against cv2 itself: every
primitive the scene renderers call, bit-equal on random cases that include
the edge cases (endpoints and centres outside the frame, zero-length lines,
horizontal and vertical lines, reversed rectangle corners)."""

import cv2
import numpy as np
import pytest

from centerpose_tpu_torch.data import draw

H, W = 96, 128
COLOR = (201, 77, 140)


def _canvas(rng):
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


def _point(rng, margin):
    return (int(rng.integers(-margin, W + margin)),
            int(rng.integers(-margin, H + margin)))


def _segments(rng, n):
    """Random segments: short ones (as the hard scenes' clutter draws:
    p + N(0, 40)), long ones across and beyond the frame, zero-length ones,
    axis-aligned ones, and both ends far outside."""
    out = []
    for i in range(n):
        p = _point(rng, 60)
        kind = i % 6
        if kind == 0:
            q = p
        elif kind == 1:
            q = (p[0], int(rng.integers(-60, H + 60)))
        elif kind == 2:
            q = (int(rng.integers(-60, W + 60)), p[1])
        elif kind == 3:
            q = tuple(int(v) for v in (np.array(p) + rng.normal(0, 40, 2))
                      .astype(int))
        elif kind == 4:
            p = (int(rng.integers(-400, -100)), int(rng.integers(-50, H + 50)))
            q = (int(rng.integers(W + 100, W + 400)),
                 int(rng.integers(-50, H + 50)))
        else:
            q = _point(rng, 60)
        out.append((p, q))
    return out


@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5, 6, 7, 8])
def test_line_matches_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for p, q in _segments(rng, 300):
        base = _canvas(rng)
        want = cv2.line(base.copy(), p, q, COLOR, thickness=thickness)
        got = draw.line(base.copy(), p, q, COLOR, thickness)
        assert np.array_equal(got, want), (p, q, thickness)


def test_circle_matches_cv2():
    rng = np.random.default_rng(1)
    for i in range(400):
        radius = int(rng.integers(0, 20))
        c = _point(rng, 25)
        base = _canvas(rng)
        want = cv2.circle(base.copy(), c, radius, COLOR, -1)
        got = draw.circle_filled(base.copy(), c, radius, COLOR)
        assert np.array_equal(got, want), (c, radius)


def test_rectangle_matches_cv2():
    rng = np.random.default_rng(2)
    for i in range(300):
        p, q = _point(rng, 30), _point(rng, 30)
        if i % 5 == 0:
            q = (p[0], q[1])  # one pixel wide
        base = _canvas(rng)
        want = cv2.rectangle(base.copy(), p, q, COLOR, -1)
        got = draw.rectangle_filled(base.copy(), p, q, COLOR)
        assert np.array_equal(got, want), (p, q)


@pytest.mark.parametrize("factor", [4, 8])
def test_resize_nearest_matches_cv2(factor):
    rng = np.random.default_rng(factor)
    small = rng.integers(0, 70, (480 // factor, 640 // factor, 3),
                         dtype=np.uint8)
    want = cv2.resize(small, (640, 480), interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(draw.resize_nearest(small, (640, 480)), want)
    with pytest.raises(ValueError):
        draw.resize_nearest(small, (641, 480))


def test_primitives_leave_the_image_uint8_in_place():
    img = np.zeros((H, W, 3), np.uint8)
    out = draw.line(img, (-10, 5), (200, 50), COLOR, 3)
    assert out is img and img.dtype == np.uint8 and img.any()
    with pytest.raises(ValueError):
        draw.line(img, (0, 0), (5, 5), COLOR, 0)
