"""The port's native library (``centerpose_tpu_torch/native``: copies of the
reference's C++ encoder fill loop and soft-NMS core) against the
reference's native library and numpy paths on the same seeded inputs, and
its build when several processes start it at once."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import centerpose_tpu.data.encode as jencode
import centerpose_tpu.native as jnative
from centerpose_tpu.ops.soft_nms import soft_nms_39_numpy as ref_soft_nms_numpy
from centerpose_tpu_torch import native
from centerpose_tpu_torch.data.encode import encode_example
from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
from centerpose_tpu_torch.ops.soft_nms import soft_nms_39, soft_nms_39_numpy

from _torch_port import jax_cfg, torch_cfg
from _torch_port import release_compiled, release_resources  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TARGETS = ("hm", "hm_hp", "wh", "hps", "reg", "reg_mask", "hps_mask",
           "hp_offset", "hp_mask")
# the reference's tolerance between its native and numpy encoders
# (tests/test_native.py)
TOL = 1e-5


def _need(lib):
    if not lib.available():
        pytest.skip("no g++: the native library cannot be built here")


def _out(r, j, k):
    return dict(
        hm=np.zeros((r, r, 1), np.float32), hm_hp=np.zeros((r, r, j), np.float32),
        wh=np.zeros((k, 2), np.float32), hps=np.zeros((k, 2 * j), np.float32),
        reg=np.zeros((k, 2), np.float32), ind=np.zeros((k,), np.int32),
        reg_mask=np.zeros((k,), np.float32),
        hps_mask=np.zeros((k, 2 * j), np.float32),
        hp_offset=np.zeros((k * j, 2), np.float32),
        hp_ind=np.zeros((k * j,), np.int32), hp_mask=np.zeros((k * j,), np.float32))


@pytest.mark.parametrize("rot", [False, True])
def test_native_fill_loop_bit_equal_to_reference_native(rot):
    _need(native)
    _need(jnative)
    r, j = 32, 17
    for seed in range(8):
        g = np.random.default_rng(seed)
        k = int(g.integers(1, 12))
        xy = g.uniform(-4, r + 4, (k, 2))
        wh = g.uniform(0, 12, (k, 2))
        bboxes = np.clip(np.concatenate([xy, xy + wh], 1), 0, r - 1)
        joints = g.uniform(-3, r + 3, (k, j, 2))
        vis = (g.random((k, j)) < 0.7).astype(np.int32)
        vis[0] = 0  # an unannotated person
        got, want = _out(r, j, k), _out(r, j, k)
        assert native.encode_targets_native(bboxes, joints, vis, r, rot, got)
        assert jnative.encode_targets_native(bboxes, joints, vis, r, rot, want)
        for key in want:
            assert np.array_equal(got[key], want[key]), (seed, key)


def test_encoder_native_matches_reference_native_and_numpy(monkeypatch):
    """On the same scenes and generator streams the port's targets (its
    native path) equal the reference's native ones and lie within 1e-5 of
    both numpy paths, indices equal."""
    _need(native)
    cfg, jcfg = torch_cfg(64), jax_cfg(64)
    ds = SyntheticPoseDataset(6, img_w=160, img_h=120, seed=4, hard=True)
    for i in range(len(ds)):
        img, anns = ds.get_raw(i)
        port = encode_example(img, anns, cfg, np.random.default_rng(i))
        ref = jencode.encode_example(img, anns, jcfg, np.random.default_rng(i))
        with monkeypatch.context() as m:
            m.setattr(jnative, "available", lambda: False)
            ref_np = jencode.encode_example(img, anns, jcfg,
                                            np.random.default_rng(i))
            m.setenv("CENTERPOSE_DISABLE_NATIVE", "1")
            assert not native.available()
            port_np = encode_example(img, anns, cfg, np.random.default_rng(i))
        for key in TARGETS:
            if jnative.available():
                assert np.array_equal(port[key], ref[key]), (i, key)
            for other in (ref_np, port_np):
                np.testing.assert_allclose(port[key], other[key], rtol=TOL,
                                           atol=TOL, err_msg=f"{i} {key}")
        for key in ("ind", "hp_ind"):
            for other in (ref, ref_np, port_np):
                assert np.array_equal(port[key], other[key]), (i, key)


def _dets(seed, n=200):
    g = np.random.default_rng(seed)
    c = g.uniform(0, 500, (max(n // 5, 1), 2))[g.integers(0, max(n // 5, 1), n)]
    c = c + g.normal(0, 6, (n, 2))
    wh = g.uniform(2, 100, (n, 2))
    d = np.zeros((n, 39), np.float32)
    d[:, :2], d[:, 2:4] = c - wh / 2, c + wh / 2
    d[:, 4] = g.uniform(0, 1, n)
    d[:, 5:] = g.uniform(0, 500, (n, 34))
    return d


@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_native_matches_reference(method):
    _need(native)
    for seed in range(6):
        d = _dets(seed)
        got = soft_nms_39(d, 0.5, 0.5, 0.001, method)
        assert got.dtype == np.float32
        if jnative.available():
            want = jnative.soft_nms_39_native(d, 0.5, 0.5, 0.001, method)
            assert np.array_equal(got, want), (seed, method)
        for other in (soft_nms_39_numpy(d, 0.5, 0.5, 0.001, method),
                      ref_soft_nms_numpy(d, 0.5, 0.5, 0.001, method)):
            assert got.shape == other.shape
            np.testing.assert_array_equal(got[:, :4], other[:, :4])
            np.testing.assert_allclose(got, other, rtol=0, atol=1e-6)


_BUILD = """
import sys, time
from pathlib import Path
import centerpose_tpu_torch.native as n
n.BUILD_DIR = Path(sys.argv[1])
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
assert n.available()
print(n.library_path())
"""


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two pytest-xdist workers (here: two processes started together)
    that find no library both compile it; each writes its own temporary
    file and renames it, so both load a whole library and no temporary
    file is left."""
    _need(native)
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path),
                               str(start)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [Path(paths.pop()).name]


def test_disabled_native_falls_back(monkeypatch):
    monkeypatch.setenv("CENTERPOSE_DISABLE_NATIVE", "1")
    assert not native.available()
    assert native.soft_nms_39_native(_dets(0)) is None
    d = _dets(1, 50)
    assert np.array_equal(soft_nms_39(d), soft_nms_39_numpy(d))
