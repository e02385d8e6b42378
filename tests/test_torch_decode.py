"""Port parity of decode, NMS/top-K, geometry and post-process."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerpose_tpu.inference.post_process import (
    multi_pose_post_process as j_post)
from centerpose_tpu.losses import sigmoid_clamped as j_sigmoid
from centerpose_tpu.ops import image as jimage
from centerpose_tpu.ops.decode import multi_pose_decode as j_decode
from centerpose_tpu.ops.nms import heat_nms as j_nms, topk as j_topk
from centerpose_tpu_torch.inference.post_process import multi_pose_post_process
from centerpose_tpu_torch.losses import sigmoid_clamped
from centerpose_tpu_torch.ops import image as timage
from centerpose_tpu_torch.ops.decode import multi_pose_decode
from centerpose_tpu_torch.ops.nms import heat_nms, topk


def _heads(seed, b=2, h=32, w=32, j=17):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (r.normal(size=s) * sc).astype(np.float32)  # noqa
    return dict(hm=f(b, h, w, 1, sc=2.0), wh=np.abs(f(b, h, w, 2, sc=8.0)),
                hps=f(b, h, w, 2 * j, sc=4.0), reg=f(b, h, w, 2, sc=0.3),
                hm_hp=f(b, h, w, j, sc=2.0), hp_offset=f(b, h, w, 2, sc=0.3))


def _decode_both(heads, k):
    jh = {n: jnp.asarray(a) for n, a in heads.items()}
    th = {n: torch.from_numpy(a) for n, a in heads.items()}
    want = np.asarray(j_decode(
        j_sigmoid(jh["hm"]), jh["wh"], jh["hps"], jh["reg"],
        j_sigmoid(jh["hm_hp"]), jh["hp_offset"], k=k))
    got = multi_pose_decode(
        sigmoid_clamped(th["hm"]), th["wh"], th["hps"], th["reg"],
        sigmoid_clamped(th["hm_hp"]), th["hp_offset"], k=k).numpy()
    return got, want


def test_sigmoid_clamped_matches():
    x = np.linspace(-20, 20, 101, dtype=np.float32)
    np.testing.assert_allclose(sigmoid_clamped(torch.from_numpy(x)).numpy(),
                               np.asarray(j_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_heat_nms_and_topk_match():
    r = np.random.default_rng(3)
    heat = r.random((2, 16, 16, 3)).astype(np.float32)
    got = heat_nms(torch.from_numpy(heat)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_nms(jnp.asarray(heat))))
    ts = topk(torch.from_numpy(got), 20)
    js = j_topk(jnp.asarray(got), 20)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_ties_keep_lowest_index_first():
    # a flat map ties everywhere (fault watch F-D); the stable sort orders
    # ties as lax.top_k does
    heat = np.full((1, 8, 8, 2), 0.25, np.float32)
    ts = topk(torch.from_numpy(heat), 10)
    js = j_topk(jnp.asarray(heat), 10)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_random_heads_match_as_sets(seed):
    got, want = _decode_both(_heads(seed), k=100)
    assert got.shape == want.shape == (2, 100, 40)
    for i in range(2):
        # compare the detections as sets of rows (ties in top-K may order
        # them differently; F-D), each row to f32 rounding
        g = got[i][np.lexsort(got[i].T[::-1])]
        w = want[i][np.lexsort(want[i].T[::-1])]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_decode_exact_order_on_distinct_scores():
    got, want = _decode_both(_heads(5), k=50)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_affine_and_post_process_match():
    c = np.array([160.0, 120.0], np.float32)
    for s, size in ((320.0, (128, 128)),
                    (np.array([384.0, 256.0], np.float32), (96, 64))):
        for inv in (False, True):
            np.testing.assert_array_equal(
                timage.get_affine_transform(c, s, 0.0, size, inv=inv),
                jimage.get_affine_transform(c, s, 0.0, size, inv=inv))
    t = jimage.get_affine_transform(c, 320.0, 0.0, (128, 128))
    np.testing.assert_array_equal(timage.affine_transform([3.0, 4.0], t),
                                  jimage.affine_transform([3.0, 4.0], t))
    assert timage.FLIP_IDX == jimage.FLIP_IDX
    dets = np.random.default_rng(2).normal(size=(2, 100, 40)).astype(
        np.float32) * 10 + 16
    cs, ss = [c, c * 1.5], [320.0, 480.0]
    got = multi_pose_post_process(dets, cs, ss, 32, 32)
    want = j_post(dets, cs, ss, 32, 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[1], b[1])
