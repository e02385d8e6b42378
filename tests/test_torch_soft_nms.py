"""The port's soft-NMS against the JAX package's: its numpy body bit-equal
to the reference's for hard, linear and Gaussian decay, and its
dispatching ``soft_nms_39`` (the C++ core when it is built) bit-equal to
the reference's dispatching one where both take the core, within 1e-6
otherwise (the core and the numpy body keep the same rows in the same
order and differ by an f32 ulp of a score)."""

import numpy as np
import pytest

from centerpose_tpu import native as ref_native
from centerpose_tpu.ops.soft_nms import soft_nms_39 as ref_dispatch
from centerpose_tpu.ops.soft_nms import soft_nms_39_numpy as ref_numpy
from centerpose_tpu_torch import native
from centerpose_tpu_torch.ops.soft_nms import soft_nms_39, soft_nms_39_numpy


def _dets(seed, n=300):
    """Pose rows as multi-scale merging sees them: clusters of overlapping
    boxes (duplicates across scales), tied scores, some degenerate boxes."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 600, (max(n // 6, 1), 2))
    c = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 8, (n, 2))
    wh = rng.uniform(2, 120, (n, 2))
    d = np.zeros((n, 39), np.float32)
    d[:, 0:2] = c - wh / 2
    d[:, 2:4] = c + wh / 2
    d[:, 4] = np.round(rng.uniform(0, 1, n), 2)
    d[:5, 2] = d[:5, 0]  # zero-width boxes
    d[:, 5:] = rng.uniform(0, 600, (n, 34))
    return d


@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_bit_equal_to_reference_numpy(method):
    for seed in range(12):
        d = _dets(seed)
        for nt, sigma, thresh in ((0.5, 0.5, 0.001), (0.3, 0.25, 0.05)):
            want = ref_numpy(d, sigma, nt, thresh, method)
            got = soft_nms_39_numpy(d, sigma, nt, thresh, method)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (seed, method, nt)


def test_soft_nms_within_1e6_of_reference_dispatch():
    both_native = native.available() and ref_native.available()
    for seed in range(20):
        d = _dets(100 + seed)
        want = ref_dispatch(d.copy(), nt=0.5, method=2)
        got = soft_nms_39(d, nt=0.5, method=2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        if both_native:
            assert np.array_equal(got, want)


def test_soft_nms_leaves_its_input_and_handles_empty():
    d = _dets(7, 20)
    before = d.copy()
    soft_nms_39(d)
    assert np.array_equal(d, before)
    assert soft_nms_39(d[:0]).shape == (0, 39)
