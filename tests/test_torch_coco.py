"""COCO-format files, the port against the reference: ``COCOHP`` on a
small COCO tree written here with cv2 (6 PNG scenes of synthetic persons
per split, a crowd annotation, an image without a person), its index,
ground truth, images and encoded items, ``run_eval`` on the same
detections, ``Detector.run`` and ``evaluate_detector`` on image paths,
and both CLIs reading the tree."""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import pytest

import centerpose_tpu.native as jnative
from centerpose_tpu.config import default_config as j_default
from centerpose_tpu.config import update_config as j_update
from centerpose_tpu.data.coco import COCOHP as JCOCOHP
from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.data.coco import COCOHP, read_image
from centerpose_tpu_torch.data.synthetic import render_scene
from centerpose_tpu_torch.eval.harness import evaluate_detector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.weights import state_dict_from_npz
from _torch_port import release_compiled, release_resources  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RES18 = str(ROOT / "output" / "res18_hard_artifact" / "params_f16.npz")


def _write_split(root: Path, split: str, seed: int, ann_id: int) -> None:
    """Six scenes of 1-3 stick figures (odd sizes), the third with a crowd
    annotation beside its persons, the fifth with no person, and a
    category-2 annotation that the index drops."""
    import cv2

    rng = np.random.default_rng(seed)
    (root / f"{split}2017").mkdir(parents=True)
    images, anns = [], []
    for k in range(6):
        h, w = 8 * int(rng.integers(12, 18)), 8 * int(rng.integers(15, 23))
        img, people = render_scene(rng, w, h, n_people=0 if k == 4
                                   else 1 + k % 3)
        h, w = h - 1 - 2 * k % 7, w - 3  # odd sizes, a margin cut off
        img = np.ascontiguousarray(img[:h, :w])
        img_id = 1000 * seed + 7 * k + 3
        name = f"{img_id:012d}.png"
        cv2.imwrite(str(root / f"{split}2017" / name),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        images.append({"id": img_id, "file_name": name, "height": h,
                       "width": w})
        for a in people:
            ann_id += 1
            anns.append(dict(a, id=ann_id, image_id=img_id, category_id=1,
                             iscrowd=0, area=a["bbox"][2] * a["bbox"][3],
                             num_keypoints=17))
        if k == 2:
            ann_id += 1
            anns.append({"id": ann_id, "image_id": img_id, "category_id": 1,
                         "iscrowd": 1, "bbox": [5.0, 5.0, 40.0, 60.0],
                         "area": 2400.0, "keypoints": [0] * 51,
                         "num_keypoints": 0})
        if k == 3:
            ann_id += 1
            anns.append({"id": ann_id, "image_id": img_id, "category_id": 2,
                         "iscrowd": 0, "bbox": [1.0, 1.0, 9.0, 9.0],
                         "area": 81.0})
    (root / "annotations").mkdir(exist_ok=True)
    with open(root / "annotations" / f"person_keypoints_{split}2017.json",
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    _write_split(root, "train", 1, 0)
    _write_split(root, "val", 2, 100)
    return root


OV = {"model": {"input_res": 64, "output_res": 16},
      "dataset": {"max_objs": 4}}


def _cfgs(root, **ov):
    o = {**OV, "dataset": {**OV["dataset"], "root": str(root)}}
    for k, v in ov.items():
        o[k] = {**o.get(k, {}), **v}
    return j_update(j_default(), o), update_config(default_config(), o)


@pytest.mark.parametrize("split", ["train", "val"])
def test_index_and_ground_truth_match_reference(coco_root, split):
    jcfg, tcfg = _cfgs(coco_root)
    ref, port = JCOCOHP(jcfg, split), COCOHP(tcfg, split)
    # train: the images with a non-crowd person (not the empty one);
    # val: every image
    assert port.img_ids == ref.img_ids
    assert len(port) == (5 if split == "train" else 6)
    assert port.gt_annotations() == ref.gt_annotations()
    assert any(a["iscrowd"] for a in port.gt_annotations())
    for i in range(len(port)):
        assert port.image_path(i) == ref.image_path(i)
        img, anns = port.get_raw(i)
        want_img, want_anns = ref.get_raw(i)
        np.testing.assert_array_equal(img, want_img)
        assert anns == want_anns and not any(a["iscrowd"] for a in anns)


@pytest.mark.parametrize("wire", ["compact", "float32"])
def test_get_item_bit_equal_to_reference(coco_root, monkeypatch, wire):
    # the reference's numpy encoder: its native fill loop is held against
    # the port's in test_torch_native.py
    monkeypatch.setattr(jnative, "available", lambda: False)
    jcfg, tcfg = _cfgs(coco_root, train={"wire": wire})
    ref, port = JCOCOHP(jcfg, "train"), COCOHP(tcfg, "train")
    for i in range(len(port)):
        for is_train in (True, False):
            got = port.get_item(i, np.random.default_rng(i), is_train)
            want = ref.get_item(i, np.random.default_rng(i), is_train)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_run_eval_matches_reference(coco_root, tmp_path):
    """The same detections (each gt person jittered, plus false positives,
    some on the empty image) through both readers' ``run_eval``: the
    keypoint and bbox stats equal; ``save_dir`` gets the results file and
    ``img_ids`` scores a subset."""
    jcfg, tcfg = _cfgs(coco_root)
    ref, port = JCOCOHP(jcfg, "val"), COCOHP(tcfg, "val")
    rng = np.random.default_rng(5)
    results = {}
    for img_id in port.img_ids:
        rows = []
        for a in port.anns_by_img.get(img_id, []):
            if a["iscrowd"]:
                continue
            x, y, w, h = a["bbox"]
            kp = np.asarray(a["keypoints"], np.float32).reshape(17, 3)[:, :2]
            box = np.array([x, y, x + w, y + h]) + rng.normal(0, 2, 4)
            rows.append(np.concatenate(
                [box, [rng.uniform(0.3, 1)],
                 (kp + rng.normal(0, 1.5, kp.shape)).reshape(-1)]))
        for _ in range(2):
            rows.append(np.concatenate([[10, 10, 50, 80, rng.uniform(0, 0.5)],
                                        rng.uniform(0, 80, 34)]))
        results[img_id] = {1: np.asarray(rows, np.float32)}
    got = port.run_eval(results, save_dir=str(tmp_path))
    want = ref.run_eval(results)
    assert got.keys() == want.keys() and "bbox_AP" in got
    assert got == want
    assert 0.2 < got["AP"] < 1.0
    with open(tmp_path / "results.json") as f:
        assert len(json.load(f)) == sum(len(r[1]) for r in results.values())
    sub = port.img_ids[:3]
    part = {i: results[i] for i in sub}
    assert port.run_eval(part, img_ids=sub) == ref.run_eval(part, img_ids=sub)


@pytest.fixture(scope="module")
def detector(coco_root):
    _, tcfg = _cfgs(coco_root, model={"name": "res_18"},
                    test={"flip_test": True})
    return Detector(tcfg, state_dict_from_npz(RES18), device="cpu")


def test_detector_run_on_a_path_equals_on_the_array(coco_root, detector):
    port = COCOHP(detector.cfg, "val")
    for img_id, path in list(port.items())[:2]:
        a = detector.run(path)["results"][1]
        b = detector.run(read_image(path))["results"][1]
        assert a.shape == (100, 39)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            read_image(path), port.get_raw(port.img_ids.index(img_id))[0])


def test_evaluate_detector_on_paths_equals_on_arrays(coco_root, detector):
    port = COCOHP(detector.cfg, "val")
    paths = list(port.items())
    arrays = [(i, read_image(p)) for i, p in paths]
    a, _, _ = evaluate_detector(detector, iter(paths), workers=2, inflight=1)
    b, _, _ = evaluate_detector(detector, iter(arrays), workers=2, inflight=1)
    assert a.keys() == b.keys() == set(port.img_ids)
    for i in a:
        np.testing.assert_array_equal(a[i][1], b[i][1])


def test_clis_train_and_evaluate_on_the_coco_tree(coco_root, tmp_path):
    """``tools/train.py`` without ``--synthetic`` (the config defaults,
    res_18 at 64x64, 2 steps, val loss and AP on the val split) and
    ``tools/evaluate.py`` without it (the res_18 snapshot), each writing
    its files under the run directory."""
    from centerpose_tpu_torch.tools import evaluate as eval_cli
    from centerpose_tpu_torch.tools import train as train_cli

    flags = ["--device", "cpu", "--defaults"]
    common = ["model.name", "res_18", "model.input_res", "64",
              "model.output_res", "16", "dataset.root", str(coco_root),
              "output_dir", str(tmp_path / "out")]
    run = train_cli.main([*flags, "--max-steps", "2", *common,
                          "train.batch_size", "2", "train.epochs", "1",
                          "train.num_workers", "0", "train.val_intervals", "1",
                          "train.val_ap_limit", "3"])
    assert run["trainer"].step == 2 and run["trainer"].cfg.model.name == "res_18"
    assert np.isfinite(run["first_loss"]) and "AP" in run["epochs"][-1]
    for name in ("model_last", "model_last.meta.json", "model_best"):
        assert os.path.exists(os.path.join(run["log_dir"], name)), name
    stats = eval_cli.main([*flags, "--workers", "2", *common,
                           "test.model_path", RES18])
    assert "AP" in stats and "bbox_AP" in stats
    with open(tmp_path / "out" / "default" / "results.json") as f:
        assert len(json.load(f)) == 6 * 100
