"""The port's OKS / bbox evaluator and detection conversion against the
JAX package's, on fixed annotations and detections that cover crowd gts,
ignored gts, joints labeled outside the frame (vis=1), unlabeled gts, every
area range, more than 20 detections per image (the keypoint cap), score
ties, images with detections and no gt and images with gt and no
detection.  Both are float64 numpy with the same arithmetic: equal to
1e-12."""

import numpy as np
import pytest

from centerpose_tpu.data.coco import COCOHP
from centerpose_tpu.eval import coco_eval as ref
from centerpose_tpu.ops.image import OKS_SIGMAS
from centerpose_tpu_torch.data.coco import convert_eval_format
from centerpose_tpu_torch.eval import coco_eval as port

TOL = 1e-12


def _gt(rng, image_id, side):
    h = side * float(rng.uniform(0.6, 1.6))
    x, y = (float(v) for v in rng.uniform(-20, 500, 2))
    n_lab = int(rng.integers(0, 18)) if rng.random() < 0.2 else 17
    lab = rng.permutation(17)[:n_lab]
    kps = []
    for j in range(17):
        if j in lab:
            kps += [float(rng.uniform(x, x + side)),
                    float(rng.uniform(y, y + h)), int(rng.choice([1, 2]))]
        else:
            kps += [0.0, 0.0, 0]
    g = {"image_id": image_id, "bbox": [x, y, side, h],
         "area": side * h * float(rng.uniform(0.5, 1.0)),
         "iscrowd": int(rng.random() < 0.1), "keypoints": kps,
         "category_id": 1}
    if rng.random() < 0.1:
        g["num_keypoints"] = n_lab
    if rng.random() < 0.05:
        g["ignore"] = 1
    return g


def _det(rng, image_id, g=None, noise=5.0):
    if g is None:
        cx, cy = rng.uniform(0, 600, 2)
        kp = np.stack([cx + rng.normal(0, 40, 17), cy + rng.normal(0, 40, 17),
                       np.ones(17)], 1)
        box = [float(cx), float(cy), float(rng.uniform(5, 300)),
               float(rng.uniform(5, 300))]
    else:
        kp = np.asarray(g["keypoints"], np.float64).reshape(17, 3).copy()
        kp[:, :2] += rng.normal(0, noise, (17, 2))
        kp[:, 2] = 1.0
        x, y, w, h = g["bbox"]
        box = [x + float(rng.normal(0, noise)), y + float(rng.normal(0, noise)),
               max(1.0, w + float(rng.normal(0, noise))),
               max(1.0, h + float(rng.normal(0, noise)))]
    return {"image_id": image_id, "category_id": 1,
            "keypoints": [float(v) for v in kp.reshape(-1)], "bbox": box,
            # two decimals: ties among detections of one image
            "score": round(float(rng.uniform(0.01, 1.0)), 2)}


def _fixture(seed):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    sides = [10, 20, 31, 32, 40, 60, 95, 96, 97, 150, 300]  # area ranges
    for img in range(8):
        n_gt = 0 if img == 6 else int(rng.integers(1, 7))
        for _ in range(n_gt):
            g = _gt(rng, img, float(rng.choice(sides)))
            gts.append(g)
            for _ in range(int(rng.integers(0, 4))):
                dts.append(_det(rng, img, g, float(rng.uniform(0.5, 30))))
        if img == 7:
            continue  # gt and no detection
        for _ in range(25 if img in (0, 6) else int(rng.integers(0, 6))):
            dts.append(_det(rng, img))  # more than 20 on images 0 and 6
    return gts, dts


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_keypoints_matches_reference(seed):
    gts, dts = _fixture(seed)
    assert max(sum(d["image_id"] == i for d in dts) for i in range(8)) > 20
    want = ref.evaluate_keypoints(gts, dts)
    got = port.evaluate_keypoints(gts, dts)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    assert 0 < want["AP"] < 1


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_bboxes_matches_reference(seed):
    gts, dts = _fixture(seed)
    want = ref.evaluate_bboxes(gts, dts)
    got = port.evaluate_bboxes(gts, dts)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


def test_accumulate_and_oks_match_reference():
    gts, dts = _fixture(9)
    want = ref.KeypointEval(gts, dts).accumulate()
    got = port.KeypointEval(gts, dts).accumulate()
    for k in ("precision", "recall"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
    np.testing.assert_array_equal(port.OKS_SIGMAS, OKS_SIGMAS)
    rng = np.random.default_rng(0)
    for g in gts[:12]:
        dk = rng.uniform(0, 600, (17, 2))
        gk = np.asarray(g["keypoints"], np.float64).reshape(17, 3)
        assert port.compute_oks(dk, gk, g["area"], g["bbox"]) == \
            ref.compute_oks(dk, gk, g["area"], g["bbox"])


def test_convert_eval_format_matches_reference():
    rng = np.random.default_rng(3)
    results = {}
    for img_id in (0, 5, 17):
        rows = rng.uniform(-50, 700, (7, 39)).astype(np.float32)
        rows[:, 4] = rng.uniform(0, 1, 7)
        results[img_id] = {1: rows}
    assert convert_eval_format(results) == \
        COCOHP.convert_eval_format(None, results)


@pytest.mark.parametrize("layout", ["TRAM", "TRA"])
def test_summarize_keypoints_matches_reference(layout):
    gts, dts = _fixture(4)
    acc = ref.KeypointEval(gts, dts).accumulate()
    if layout == "TRA":  # the older layout without the max-detections axis
        acc = {"precision": acc["precision"][..., 0],
               "recall": acc["recall"][..., 0]}
    want = ref.summarize_keypoints(acc)
    got = port.summarize_keypoints(acc)
    assert list(got) == list(want) and len(got) == 10
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])
    assert 0 < got["AP"] < 1
