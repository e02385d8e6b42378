"""Detector parity: the port's cv2-free pre-process and its device stage
against the JAX Detector, with the dla_34 snapshot at 128x128."""

import numpy as np
import pytest

from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.weights import state_dict_from_npz

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
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        # float32 bilinear against cv2's interpolation arithmetic: they may
        # round a value on the other side of .5, never more than one level
        assert d.max() <= 1 and d.mean() < 0.05
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
    for key in ("tot", "pre", "net", "post"):
        assert ret[key] >= 0


def test_unported_options_raise(weights):
    _, sd = weights
    with pytest.raises(NotImplementedError):
        Detector(torch_cfg(128, test={"test_scales": (0.75, 1.0)}), sd,
                 device="cpu")
    with pytest.raises(NotImplementedError):
        Detector(torch_cfg(128, name="res_18"), device="cpu")


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
