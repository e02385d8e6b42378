"""Visualisation: skeleton and heatmap overlays.

Counterpart of ``centerpose_tpu/utils/debugger.py``: cv2 drawing on the
host, used by the demo (``tools/demo.py``) and by ``debug > 0`` training
(``render_train_debug``).  cv2 is imported inside each method that draws,
blends or writes: the package's device paths run without it.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from centerpose_tpu_torch.data.synthetic import COCO_EDGES
from centerpose_tpu_torch.train.trainer import batch_to_device, unpack_batch

# Per-edge BGR colours (one palette for every frame).
_EDGE_COLORS = [
    (255, 0, 0), (0, 0, 255), (255, 0, 0), (0, 0, 255),
    (255, 0, 0), (0, 0, 255), (255, 0, 255),
    (255, 0, 0), (255, 0, 0), (0, 0, 255), (0, 0, 255),
    (255, 0, 0), (0, 0, 255), (255, 0, 255),
    (255, 0, 0), (255, 0, 0), (0, 0, 255), (0, 0, 255),
]


class Debugger:
    """Named BGR uint8 images to draw on, blend into and write out."""

    def __init__(self):
        self.imgs: Dict[str, np.ndarray] = {}

    def add_img(self, img: np.ndarray, img_id: str = "default") -> None:
        self.imgs[img_id] = img.copy()

    def add_coco_bbox(self, bbox, conf, img_id: str = "default") -> None:
        import cv2

        x1, y1, x2, y2 = [int(v) for v in bbox[:4]]
        cv2.rectangle(self.imgs[img_id], (x1, y1), (x2, y2), (0, 255, 0), 2)
        cv2.putText(
            self.imgs[img_id], f"person {conf:.2f}", (x1, max(0, y1 - 4)),
            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1, cv2.LINE_AA)

    def add_coco_hp(self, points, img_id: str = "default") -> None:
        """Draw a 17-joint skeleton; ``points``: [34] or [17, 2]."""
        import cv2

        pts = np.asarray(points, np.float32).reshape(17, 2).astype(np.int32)
        for j in range(17):
            cv2.circle(self.imgs[img_id], tuple(pts[j]), 3, (0, 0, 255), -1)
        for e_idx, (a, b) in enumerate(COCO_EDGES):
            if np.all(pts[a] >= 0) and np.all(pts[b] >= 0):
                cv2.line(self.imgs[img_id], tuple(pts[a]), tuple(pts[b]),
                         _EDGE_COLORS[e_idx % len(_EDGE_COLORS)], 2,
                         cv2.LINE_AA)

    def add_blend_heatmap(self, img: np.ndarray, hm: np.ndarray,
                          img_id: str = "hm") -> None:
        """Overlay a heatmap [H, W] or [H, W, C] (its max over channels) in
        the JET colour map on ``img``."""
        import cv2

        h = np.max(np.asarray(hm, np.float32), axis=-1) if hm.ndim == 3 else hm
        h = cv2.resize(h, (img.shape[1], img.shape[0]))
        h = np.clip(h * 255, 0, 255).astype(np.uint8)
        color = cv2.applyColorMap(h, cv2.COLORMAP_JET)
        self.imgs[img_id] = cv2.addWeighted(img, 0.6, color, 0.4, 0)

    def add_multi_pose(self, results: np.ndarray, vis_thresh: float = 0.3,
                       img_id: str = "default") -> None:
        """Draw every detection row [N, 39] scoring >= ``vis_thresh``."""
        for row in np.asarray(results):
            if row[4] >= vis_thresh:
                self.add_coco_bbox(row[:4], row[4], img_id)
                self.add_coco_hp(row[5:39], img_id)

    def save_all_imgs(self, path: str, prefix: str = "") -> None:
        import cv2

        os.makedirs(path, exist_ok=True)
        for name, img in self.imgs.items():
            cv2.imwrite(os.path.join(path, f"{prefix}{name}.png"), img)

    def show_all_imgs(self, pause: bool = False) -> None:
        import cv2

        for name, img in self.imgs.items():
            cv2.imshow(name, img)
        cv2.waitKey(0 if pause else 1)


def _sigmoid(x: torch.Tensor) -> np.ndarray:
    x = x.float().cpu().numpy()
    return 1.0 / (1.0 + np.exp(-x))


def render_train_debug(model: torch.nn.Module, batch: Mapping, cfg,
                       out_dir: str, max_images: int = 4) -> None:
    """Predicted against ground-truth center and joint heatmaps for the
    first ``max_images`` examples of a training batch (numpy arrays or
    tensors, either wire): ``img{i}_{pred_hm,gt_hm,pred_hm_hp,gt_hm_hp}.png``
    in ``out_dir``.  The model runs one eval-mode forward on its own device
    without gradients and is left in the mode it was in."""
    keys = [k for k in ("input", "hm", "hm_hp", "aug") if k in batch]
    device = next(model.parameters()).device
    b = unpack_batch(batch_to_device(
        {k: batch[k][:max_images] for k in keys}, device), cfg)
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = model(b["input"])
    finally:
        model.train(training)
    pred_hm, pred_hm_hp = _sigmoid(out["hm"]), _sigmoid(out["hm_hp"])
    inputs, gt_hm, gt_hm_hp = (b[k].float().cpu().numpy()
                               for k in ("input", "hm", "hm_hp"))
    mean = np.asarray(cfg.dataset.mean, np.float32)
    std = np.asarray(cfg.dataset.std, np.float32)
    for i in range(inputs.shape[0]):
        img = np.clip((inputs[i] * std + mean) * 255.0, 0, 255).astype(np.uint8)
        img = img[..., ::-1].copy()  # RGB -> BGR for cv2's writes
        dbg = Debugger()
        dbg.add_blend_heatmap(img, pred_hm[i], "pred_hm")
        dbg.add_blend_heatmap(img, gt_hm[i], "gt_hm")
        dbg.add_blend_heatmap(img, pred_hm_hp[i], "pred_hm_hp")
        dbg.add_blend_heatmap(img, gt_hm_hp[i], "gt_hm_hp")
        dbg.save_all_imgs(out_dir, prefix=f"img{i}_")
