"""COCO person-keypoint data, counterpart of ``centerpose_tpu/data/coco.py``.

``COCOHP`` reads the COCO 2017 keypoint annotation files (JSON, no
pycocotools), decodes images, hands (image, annotations) pairs to the
port's encoder and drives the evaluation (``convert_eval_format``,
``run_eval``: OKS keypoint AP and the bbox pass).  Expected layout:

  {root}/annotations/person_keypoints_{split}2017.json
  {root}/{split}2017/*.jpg

Images are decoded with ``cv2.imread`` (``read_image``), imported inside
the call as the reference does: cv2 stays off the import path of the
package, whose device paths run where cv2 may be missing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from centerpose_tpu_torch.data.encode import encode_example


def read_image(path: str) -> np.ndarray:
    """An image file as an RGB uint8 [H, W, 3] array (``cv2.imread`` and
    BGR -> RGB, as the reference decodes)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def convert_eval_format(results: Dict[int, Dict[int, np.ndarray]]) -> List[dict]:
    """{image_id: {1: [N, 39]}} -> COCO detection dicts.

    Row layout: bbox (x1, y1, x2, y2) + score + 17 joints (x, y); the box
    becomes xywh and the joints 17 x [x, y, 1], rounded to 2 decimals.
    """
    dets = []
    for img_id, by_cat in results.items():
        for row in np.asarray(by_cat[1]):
            x1, y1, x2, y2, score = [float(v) for v in row[:5]]
            kps = np.asarray(row[5:39], np.float64).reshape(17, 2)
            kp_out = np.concatenate([kps, np.ones((17, 1))], axis=1).reshape(-1)
            dets.append({
                "image_id": int(img_id),
                "category_id": 1,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": score,
                "keypoints": [round(float(v), 2) for v in kp_out],
            })
    return dets


class COCOHP:
    """COCO keypoints dataset of one split: an image-level index over the
    person annotations (category 1).  ``train`` keeps the images with at
    least one non-crowd person; ``val`` keeps every image (detections on an
    image without a person count as false positives).  Works with
    ``data/loader.DataLoader`` (``__len__``, ``get_raw``; it pickles to
    spawned workers)."""

    num_joints = 17

    def __init__(self, cfg, split: str = "train"):
        self.cfg = cfg
        self.split = split
        root = cfg.dataset.root
        ann_path = os.path.join(root, "annotations",
                                f"person_keypoints_{split}2017.json")
        if not os.path.exists(ann_path):
            raise FileNotFoundError(
                f"no COCO annotation file {ann_path} (set dataset.root to "
                f"a directory holding annotations/ and {split}2017/)")
        self.img_dir = os.path.join(root, f"{split}2017")
        with open(ann_path) as f:
            data = json.load(f)
        self.images_info: Dict[int, dict] = {im["id"]: im
                                             for im in data["images"]}
        anns_by_img: Dict[int, List[dict]] = {}
        for ann in data.get("annotations", []):
            if ann.get("category_id") == 1:
                anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.anns_by_img = anns_by_img
        if split == "train":
            self.img_ids = [i for i in sorted(anns_by_img)
                            if any(not a.get("iscrowd", 0)
                                   for a in anns_by_img[i])]
        else:
            self.img_ids = sorted(self.images_info)

    def __len__(self) -> int:
        return len(self.img_ids)

    def image_path(self, i: int) -> str:
        info = self.images_info[self.img_ids[i]]
        return os.path.join(self.img_dir, info["file_name"])

    def get_raw(self, i: int) -> Tuple[np.ndarray, List[dict]]:
        """(RGB uint8 image, its non-crowd person annotations)."""
        anns = [a for a in self.anns_by_img.get(self.img_ids[i], [])
                if not a.get("iscrowd", 0)]
        return read_image(self.image_path(i)), anns

    def get_item(self, i: int, rng: Optional[np.random.Generator] = None,
                 is_train: bool = True) -> Dict[str, np.ndarray]:
        img, anns = self.get_raw(i)
        return encode_example(img, anns, self.cfg, rng, is_train)

    def items(self):
        """Yield (image_id, image path) pairs, for ``Detector.run`` and
        ``eval/harness.evaluate_detector``, which decode the path."""
        for i in range(len(self)):
            yield self.img_ids[i], self.image_path(i)

    def gt_annotations(self) -> List[dict]:
        """Every person annotation of the split's images (crowd included:
        the evaluator ignores those)."""
        out = []
        for img_id in self.img_ids:
            out.extend(self.anns_by_img.get(img_id, []))
        return out

    def convert_eval_format(self, results) -> List[dict]:
        return convert_eval_format(results)

    def run_eval(self, results: Dict[int, Dict[int, np.ndarray]],
                 save_dir: Optional[str] = None,
                 img_ids=None) -> Dict[str, float]:
        """OKS keypoint AP of ``results`` and the bbox pass under
        ``bbox_*`` keys; the detections are written to
        ``save_dir/results.json`` when given.  ``img_ids``: score only that
        subset of the split (the in-training ``val_ap_limit`` pass: partial
        results against the whole split's gts would count every image not
        run as all misses)."""
        from centerpose_tpu_torch.eval.coco_eval import (evaluate_bboxes,
                                                         evaluate_keypoints)

        dets = self.convert_eval_format(results)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "results.json"), "w") as f:
                json.dump(dets, f)
        gts = self.gt_annotations()
        if img_ids is not None:
            ids = set(int(i) for i in img_ids)
            gts = [g for g in gts if int(g["image_id"]) in ids]
        stats = evaluate_keypoints(gts, dets)
        stats.update({f"bbox_{k}": v
                      for k, v in evaluate_bboxes(gts, dets).items()})
        return stats
