"""The port's fixed-K on-device soft-NMS (``soft_nms_39_jit``) against the
JAX package's on seeded [K, 39] rows: K 8 and 100, identical boxes, tied
scores, zero-area boxes, ``thresh`` 0 and 0.001.  Nothing is reordered;
the boxes and joints come out bit-equal and the decayed scores within
rtol 1e-6 (the IoU and its decay are the same f32 ops; ``exp`` may
differ by an ulp between XLA and torch).  Also the reference's own check:
each score equals the host ``soft_nms_39``'s for the same box."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerpose_tpu.ops.soft_nms import soft_nms_39_jit as ref_jit
from centerpose_tpu_torch.ops.soft_nms import soft_nms_39, soft_nms_39_jit


def _rows(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 200, (max(k // 5, 1), 2))
    c = centres[rng.integers(0, len(centres), k)] + rng.normal(0, 6, (k, 2))
    wh = rng.uniform(4, 60, (k, 2))
    d = np.zeros((k, 39), np.float32)
    d[:, 0:2] = c - wh / 2
    d[:, 2:4] = c + wh / 2
    d[:, 4] = np.round(rng.uniform(0, 1, k), 1)  # many tied scores
    d[1, :4] = d[0, :4]  # identical boxes
    d[2, :4] = d[0, :4]
    d[2, 4] = d[0, 4]  # identical box and tied score
    d[3, 2] = d[3, 0]  # zero-area box
    d[4, 4] = 0.0005  # below thresh from the start
    d[:, 5:] = rng.uniform(0, 200, (k, 34))
    return d


@pytest.mark.parametrize("k", [8, 100])
@pytest.mark.parametrize("thresh", [0.0, 0.001])
def test_soft_nms_jit_matches_reference(k, thresh):
    for seed in range(3):
        d = _rows(seed, k)
        want = np.asarray(ref_jit(jnp.asarray(d), thresh=thresh))
        got = soft_nms_39_jit(torch.from_numpy(d), thresh=thresh)
        assert got.shape == (k, 39) and got.dtype == torch.float32
        got = got.numpy()
        np.testing.assert_array_equal(np.delete(got, 4, 1),
                                      np.delete(want, 4, 1))
        np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-6, atol=0)
        assert (got[:, 4] < d[:, 4]).any()  # something was decayed


def test_soft_nms_jit_batched_rows_independent():
    d = np.stack([_rows(s, 100) for s in range(3)])
    got = soft_nms_39_jit(torch.from_numpy(d)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], soft_nms_39_jit(torch.from_numpy(d[i])).numpy())


def test_soft_nms_jit_matches_host_decay():
    # the reference's check (tests/test_detector.py): each row's decayed
    # score equals the host soft-NMS's for the same box
    rng = np.random.default_rng(0)
    dets = np.zeros((8, 39), np.float32)
    for i in range(8):
        x, y = rng.uniform(0, 50, 2)
        w, h = rng.uniform(5, 20, 2)
        dets[i, :5] = [x, y, x + w, y + h, rng.uniform(0.1, 1.0)]
    host = soft_nms_39(dets, method=2, thresh=0.0)
    dev = soft_nms_39_jit(torch.from_numpy(dets), thresh=0.0).numpy()
    host_by_x = {round(float(r[0]), 3): float(r[4]) for r in host}
    assert len(host_by_x) == 8
    for r in dev:
        np.testing.assert_allclose(r[4], host_by_x[round(float(r[0]), 3)],
                                   rtol=1e-4)
