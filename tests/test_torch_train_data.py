"""Port parity of the training data path: the numpy image helpers, the
synthetic person, and ``encode_example`` / ``stack_batch`` against the JAX
package's on the same generator streams."""

import numpy as np
import pytest

import centerpose_tpu.data.encode as jencode
import centerpose_tpu.native as jnative
import centerpose_tpu.ops.image as jimage
from centerpose_tpu.data.synthetic import make_person as j_make_person
from centerpose_tpu_torch.data.encode import encode_example, stack_batch
from centerpose_tpu_torch.data.synthetic import make_person
from centerpose_tpu_torch import native
from centerpose_tpu_torch.ops import image

from _torch_port import jax_cfg, torch_cfg

# The port's warp is bit-equal to cv2.warpAffine on uint8 images, so the
# encoded input is too, on either wire (the float32 wire's colour
# augmentation is the same numpy code on the same uint8 values).
WARP_MAX_DIFF = {"compact": 0, "float32": 0}


def _scene(seed, h=120, w=160, people=3):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (h, w, 3), np.uint8)
    anns = [make_person(r, w, h)[0] for _ in range(people)]
    return img, anns


def test_image_helpers_match_jax():
    for det in [(3.0, 5.0), (17.5, 40.2), (100.0, 61.0)]:
        assert image.gaussian_radius(det) == jimage.gaussian_radius(det)
    for r in (0, 1, 4, 9):
        hm_a = np.zeros((40, 50), np.float32)
        hm_b = np.zeros((40, 50), np.float32)
        for c in ((3, 4), (48, 39), (20, 20)):
            image.draw_umich_gaussian(hm_a, c, r)
            jimage.draw_umich_gaussian(hm_b, c, r)
        np.testing.assert_array_equal(hm_a, hm_b)
        reg_a = np.zeros((2, 40, 50), np.float32)
        reg_b = np.zeros((2, 40, 50), np.float32)
        image.draw_dense_reg(reg_a, hm_a.copy(), (10, 12), (1.5, -2.0), r, True)
        jimage.draw_dense_reg(reg_b, hm_b.copy(), (10, 12), (1.5, -2.0), r, True)
        np.testing.assert_array_equal(reg_a, reg_b)
    for seed in range(4):
        a = image.color_aug_coeffs(np.random.default_rng(seed))
        b = jimage.color_aug_coeffs(np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        img = np.random.default_rng(seed).random((8, 9, 3), dtype=np.float32)
        np.testing.assert_array_equal(
            image.color_aug(np.random.default_rng(seed), img.copy()),
            jimage.color_aug(np.random.default_rng(seed), img.copy()))
    np.testing.assert_array_equal(image.COLOR_AUG_IDENTITY,
                                  jimage.COLOR_AUG_IDENTITY)
    pts = np.random.default_rng(0).random((2, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.flip_joints(pts, 64.0),
                                  jimage.flip_joints(pts, 64.0))


def test_make_person_matches_jax():
    for seed in range(3):
        a, ja = make_person(np.random.default_rng(seed), 640, 480)
        b, jb = j_make_person(np.random.default_rng(seed), 640, 480)
        assert a == b
        np.testing.assert_array_equal(ja, jb)


@pytest.mark.parametrize("wire", ["compact", "float32"])
@pytest.mark.parametrize("is_train", [True, False])
def test_encode_example_matches_jax(monkeypatch, wire, is_train):
    # the JAX encoder's numpy path (the port's); its native C++ fill loop
    # is not ported yet
    monkeypatch.setattr(jnative, "available", lambda: False)
    ov = {"train": {"wire": wire}, "dataset": {"max_objs": 4}}
    from centerpose_tpu.config import update_config as jupdate
    from centerpose_tpu_torch.config import update_config

    jcfg = jupdate(jax_cfg(64), ov)
    tcfg = update_config(torch_cfg(64), ov)
    examples = []
    for seed in range(6):
        img, anns = _scene(seed, people=1 + seed % 5)  # 5 > max_objs
        got = encode_example(img, anns, tcfg, np.random.default_rng(seed),
                             is_train)
        want = jencode.encode_example(img, anns, jcfg,
                                      np.random.default_rng(seed), is_train)
        assert got.keys() == want.keys()
        for k in want:
            if k == "input":
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        a, b = got["input"], want["input"]
        assert a.dtype == b.dtype and a.shape == b.shape == (64, 64, 3)
        if wire == "compact":
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        else:  # back to uint8 levels: x * std + mean, times 255
            std = np.asarray(tcfg.dataset.std, np.float32)
            diff = np.abs(a - b) * std * 255.0
        assert diff.max() <= WARP_MAX_DIFF[wire]
        examples.append(got)
    batch = stack_batch(examples)
    assert batch["hm"].shape == (6, 16, 16, 1)
    assert batch["ind"].shape == (6, 4) and batch["ind"].dtype == np.int32


@pytest.mark.parametrize("chunk", range(4))
def test_warp_affine_bit_equal_to_cv2(chunk):
    """``ops/image.warp_affine`` on uint8 and the native library's warp
    (the encoder's path) against ``cv2.warpAffine`` (INTER_LINEAR,
    constant 0 border) over 40 seeded rotation / scale / shift matrices
    (10 per case) on odd image and output sizes, outputs narrower than one
    vector of cv2's row loop included: bit-equal."""
    import cv2
    import torch

    r = np.random.default_rng(100 + chunk)
    for i in range(10):
        h, w = (int(v) for v in r.integers(5, 260, 2) | 1)
        img = r.integers(0, 256, (h, w, 3), np.uint8)
        c = np.array([w / 2 + r.uniform(-30, 30), h / 2 + r.uniform(-30, 30)],
                     np.float32)
        s = float(max(h, w) * r.uniform(0.4, 1.8))
        rot = float(r.uniform(-180, 180)) if i % 3 else 0.0
        out = (int(r.integers(1, 15)) if i == 0 else int(r.integers(15, 200)),
               int(r.integers(1, 200)))
        trans = image.get_affine_transform(
            c, s, rot, out, shift=tuple(r.uniform(-0.2, 0.2, 2)))
        want = cv2.warpAffine(img, trans, out, flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = image.warp_affine(torch.from_numpy(img), trans, out)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(i))
        if native.available():  # the encoder's path where g++ builds it
            got = native.warp_affine_native(img, image.cv2_inverse(trans),
                                            image.CV2_LANES, *out)
            np.testing.assert_array_equal(got, want, err_msg=f"native {i}")
