"""Detector parity: the port's cv2-free pre-process (resize and warp), its
device stage, the multi-scale merge and whole runs against the JAX
Detector, with the dla_34 snapshot at 128x128."""

import numpy as np
import pytest

from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.weights import state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ, jax_cfg, jax_variables, torch_cfg


def _images():
    # odd sizes so that the warp samples at arbitrary fractions
    r = np.random.default_rng(0)
    yy, xx = np.mgrid[0:237, 0:311]
    smooth = np.stack([(xx * 0.7) % 256, (yy * 0.9) % 256,
                       ((xx + yy) * 0.4) % 256], -1).astype(np.uint8)
    noise = r.integers(0, 256, (237, 311, 3), dtype=np.uint8)
    return smooth, noise


@pytest.fixture(scope="module")
def weights():
    return jax_variables(), state_dict_from_npz(NPZ)


def _pair(weights, **test):
    jv, sd = weights
    return (JaxDetector(jax_cfg(128, test=test), variables=jv),
            Detector(torch_cfg(128, test=test), sd, device="cpu"))


@pytest.mark.parametrize("keep_res", [False, True])
def test_pre_process_matches_cv2(weights, keep_res):
    jd, td = _pair(weights, keep_res=keep_res)
    for img in _images():
        want, wmeta = jd.pre_process(img)
        got, gmeta = td.pre_process(img)
        assert got.dtype.is_floating_point is False
        assert tuple(got.shape) == want.shape
        # cv2's resize and float32 warp arithmetic, bit for bit
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(gmeta["s"]),
                                      np.asarray(wmeta["s"]))
        np.testing.assert_array_equal(gmeta["c"], wmeta["c"])
        assert (gmeta["out_height"], gmeta["out_width"]) == (
            wmeta["out_height"], wmeta["out_width"])


@pytest.mark.parametrize("flip_test", [False, True])
def test_run_batch_matches_jax_detector(weights, flip_test):
    jd, td = _pair(weights, flip_test=flip_test)
    batch = np.concatenate([jd.pre_process(img)[0] for img in _images()])
    want = jd.run_batch(batch)
    got = td.run_batch(batch)
    assert got.shape == want.shape == (2, 100, 40)
    # f32 model on both sides (heads agree to ~1e-6 relative)
    np.testing.assert_allclose(got[:, :, 4], want[:, :, 4], atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_run_end_to_end_matches_jax(weights):
    jd, td = _pair(weights)
    img = _images()[0]
    want = jd.run(img)["results"][1]
    ret = td.run(img)
    got = ret["results"][1]
    assert got.shape == want.shape == (100, 39)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-2)
    for key in ("tot", "load", "pre", "net", "post", "merge"):
        assert ret[key] >= 0
    assert ret["tot"] >= ret["load"] + ret["pre"] + ret["net"] + ret["post"]


def test_unported_options_raise(weights):
    # every option the reference has now runs: the last one ported, the
    # 'conv' DCN ablation, serves (a plain conv at each site, no offsets)
    det = Detector(torch_cfg(128, dcn_impl="conv"), device="cpu")
    assert not any("conv_offset_mask" in k for k in det.model.state_dict())
    dets = det.run_batch(np.zeros((1, 128, 128, 3), np.uint8))
    assert dets.shape == (1, 100, 40) and np.isfinite(dets).all()


def test_multi_scale_and_nms_run(weights):
    _, sd = weights
    img = _images()[0]
    for test in ({"test_scales": (0.75, 1.0)}, {"nms": True}):
        td = Detector(torch_cfg(128, test=test), sd, device="cpu")
        ret = td.run(img)
        res = ret["results"][1]
        assert res.dtype == np.float32 and res.shape[1] == 39
        assert 0 < len(res) <= 100 and np.isfinite(res).all()
        # soft-NMS drops rows at score <= 0.001 and returns them by score
        assert (res[:, 4] > 0.001).all() and (np.diff(res[:, 4]) <= 0).all()
        for key in ("tot", "pre", "net", "post", "merge"):
            assert ret[key] >= 0


@pytest.mark.parametrize("scale", [0.75, 1.25])
def test_resize_linear_matches_cv2(scale):
    import cv2
    import torch

    from centerpose_tpu_torch.data.synthetic import render_scene_hard
    from centerpose_tpu_torch.ops.image import resize_linear

    # the scale ladder's sizes of a 640x480 scene, and of odd sizes; cv2's
    # uint8 path is 11-bit fixed point, which the port follows exactly
    imgs = [render_scene_hard(np.random.default_rng(0))[0], *_images()]
    for img in imgs:
        h, w = img.shape[:2]
        size = (int(w * scale), int(h * scale))
        got = resize_linear(torch.from_numpy(img), size)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), cv2.resize(img, size))
        t = torch.from_numpy(img)
        assert resize_linear(t, (w, h)) is t  # scale 1.0: no resampling


def _per_scale_rows(seed, n_scales=3):
    """Detections of one image as post_process gives them per scale:
    [100, 39] float32, boxes around shared people (duplicates across
    scales), joints inside."""
    rng = np.random.default_rng(seed)
    people = rng.uniform(50, 550, (6, 2))
    out = []
    for _ in range(n_scales):
        c = people[rng.integers(0, 6, 100)] + rng.normal(0, 6, (100, 2))
        wh = rng.uniform(10, 150, (100, 2))
        rows = np.concatenate([c - wh / 2, c + wh / 2,
                               rng.uniform(0, 0.9, (100, 1)),
                               rng.uniform(0, 600, (100, 34))], 1)
        out.append({1: rows.astype(np.float32)})
    return out


@pytest.mark.parametrize("test", [{}, {"nms": True},
                                  {"test_scales": (0.75, 1.0, 1.25)}])
def test_merge_outputs_matches_reference(weights, monkeypatch, test):
    from centerpose_tpu import native as ref_native
    from centerpose_tpu.inference import detector as ref_detector
    from centerpose_tpu.ops.soft_nms import soft_nms_39_numpy
    from centerpose_tpu_torch import native
    from centerpose_tpu_torch.inference import detector as port_detector
    from centerpose_tpu_torch.ops.soft_nms import (
        soft_nms_39_numpy as port_soft_nms_39_numpy)

    jd, td = _pair(weights, **test)
    n = len(td.cfg.test.test_scales)
    both_native = native.available() and ref_native.available()
    for seed in range(4):
        dets = _per_scale_rows(seed, n)
        dispatched = jd.merge_outputs([{1: d[1].copy()} for d in dets])[1]
        got = td.merge_outputs([{1: d[1].copy()} for d in dets])[1]
        # both soft-NMS take the same C++ core when it is built (the numpy
        # body is an f32 ulp of a score away from it)
        if both_native:
            assert np.array_equal(got, dispatched)
        np.testing.assert_allclose(got, dispatched, rtol=0, atol=1e-6)
        # on the two numpy bodies the merge is bit-equal
        with monkeypatch.context() as m:
            m.setattr(ref_detector, "soft_nms_39", soft_nms_39_numpy)
            m.setattr(port_detector, "soft_nms_39", port_soft_nms_39_numpy)
            want = jd.merge_outputs([{1: d[1].copy()} for d in dets])[1]
            got_numpy = td.merge_outputs([{1: d[1].copy()} for d in dets])[1]
        assert got.dtype == got_numpy.dtype == want.dtype == np.float32
        assert np.array_equal(got_numpy, want)
        assert 0 < len(got) <= 100


def _hard_scenes(n):
    from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset

    return [img for _, img in SyntheticEvalDataset(n, seed=3,
                                                   hard=True).items()]


def test_run_flip_multi_scale_matches_jax(weights):
    jd, td = _pair(weights, flip_test=True, test_scales=(0.75, 1.0, 1.25))
    for img in _hard_scenes(4):
        ret = td.run(img)
        got, want = ret["results"][1], jd.run(img)["results"][1]
        # f32 model on both sides, the same inputs (the resize bit-equal,
        # the warp equal at these sizes): the end-to-end tolerances of
        # test_run_end_to_end_matches_jax
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-2)
        assert ret["merge"] > 0


def test_detector_keeps_dcn_operands_contiguous(weights):
    # the kernel wrapper refuses strided operands on the card; the model's
    # NHWC conversion must leave the DCN parameters in the op's layout
    import torch

    from centerpose_tpu_torch.models.dla import DCN

    _, td = _pair(weights)
    dcns = [m for m in td.model.modules() if isinstance(m, DCN)]
    assert len(dcns) == 16
    for m in dcns:
        for p in m.parameters():
            assert p.is_contiguous()
    convs = [m for m in td.model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(c.weight.is_contiguous(memory_format=torch.channels_last)
               for c in convs)
