"""Ground-truth target encoder for multi-person pose (host-side numpy).

Counterpart of ``centerpose_tpu/data/encode.py``.  Per image it produces the
supervision dict the train step consumes: random scale/shift/flip/colour
augmentation, the affine warp to ``input_res``, and the stride-4 targets
(center gaussian ``hm``, joint gaussians ``hm_hp`` with the CornerNet
radius at min_overlap 0.7, ``wh``/``reg``/``hps``/``hp_offset`` at sparse
``ind``/``hp_ind`` with their masks; ``max_objs`` objects).  Images and
heatmaps are HWC; randomness flows through an explicit
``np.random.Generator``.  Given the same generator stream every target is
bit-equal to the JAX package's.  As there, the per-object fill loop runs in
C++ (``native/encoder.cpp``) when the native library is available and
``loss.dense_hp`` is off; the Python loop is the fallback and the
behavioural reference.

The image warp is bit-equal to the JAX package's ``cv2.warpAffine`` on
uint8 images (the native library's ``warp.cpp``, else
``ops/image.warp_affine`` on a CPU tensor), so every output is bit-equal
too (``tests/test_torch_train_data.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from centerpose_tpu_torch import native
from centerpose_tpu_torch.ops.image import (
    COLOR_AUG_IDENTITY,
    CV2_LANES,
    FLIP_IDX,
    affine_transform_batch,
    color_aug,
    color_aug_coeffs,
    cv2_inverse,
    draw_umich_gaussian,
    gaussian_radius,
    get_affine_transform,
    warp_affine,
)


def _warp_image(img: np.ndarray, trans: np.ndarray, out_w: int,
                out_h: int) -> np.ndarray:
    """uint8 HWC warp with a zero border (``cv2.warpAffine``'s
    arithmetic): the native library's, else ``ops/image.warp_affine``."""
    out = native.warp_affine_native(img, cv2_inverse(trans), CV2_LANES,
                                    out_w, out_h)
    if out is not None:
        return out
    return warp_affine(torch.from_numpy(np.ascontiguousarray(img)), trans,
                       (out_w, out_h)).numpy()


def encode_example(
    img: np.ndarray,
    anns: list,
    cfg,
    rng: Optional[np.random.Generator] = None,
    is_train: bool = True,
) -> Dict[str, np.ndarray]:
    """Encode one image + person annotations into a supervision dict.

    Args:
      img: HWC uint8 RGB image.
      anns: list of dicts with 'bbox' [x, y, w, h] and 'keypoints' (len 51,
        COCO [x, y, vis] * 17).
      cfg: full config (uses model.{input_res, output_res, num_joints},
        dataset.{scale, shift, rotate, flip, no_color_aug, max_objs, mean,
        std}, loss.dense_hp, train.wire).
      rng: numpy Generator (default: seeded with 0).
      is_train: apply augmentation when True.

    Returns dict with keys:
      input [H, W, 3] (f32 normalised, or uint8 pre-aug under the compact
      wire, which adds aug [6]); hm [h, w, 1]; hm_hp [h, w, J] (f16 under
      the compact wire); wh/reg [K, 2]; hps [K, 2J]; ind [K] i32;
      reg_mask [K] f32; hps_mask [K, 2J] f32; hp_offset [K*J, 2];
      hp_ind [K*J] i32; hp_mask [K*J] f32; and meta entries c, s.
    """
    if rng is None:
        rng = np.random.default_rng(0)

    height, width = img.shape[0], img.shape[1]
    in_res = cfg.model.input_res
    out_res = cfg.model.output_res
    num_joints = cfg.model.num_joints
    max_objs = cfg.dataset.max_objs

    c = np.array([width / 2.0, height / 2.0], dtype=np.float32)
    s = float(max(height, width))
    rot = 0.0
    flipped = False

    if is_train:
        sf, cf = cfg.dataset.scale, cfg.dataset.shift
        c[0] += s * np.clip(rng.standard_normal() * cf, -2 * cf, 2 * cf)
        c[1] += s * np.clip(rng.standard_normal() * cf, -2 * cf, 2 * cf)
        s = s * float(np.clip(rng.standard_normal() * sf + 1.0, 1 - sf, 1 + sf))
        if cfg.dataset.rotate > 0 and rng.random() < 0.5:
            rf = cfg.dataset.rotate
            rot = float(np.clip(rng.standard_normal() * rf, -2 * rf, 2 * rf))
        if rng.random() < cfg.dataset.flip:
            flipped = True
            img = img[:, ::-1, :]
            c[0] = width - c[0] - 1

    trans_input = get_affine_transform(c, s, rot, (in_res, in_res))
    inp = _warp_image(img, trans_input, in_res, in_res)
    wire = getattr(cfg.train, "wire", "float32")
    aug_coeffs = None
    if wire == "compact":
        # ship the PRE-aug uint8 warp + the sampled color-aug
        # coefficients; /255, aug replay and normalization happen on the
        # device (trainer.unpack_batch).  Same rng stream as the f32 path
        # (color_aug_coeffs docstring).
        if is_train and not cfg.dataset.no_color_aug:
            aug_coeffs = color_aug_coeffs(rng)
        else:
            aug_coeffs = COLOR_AUG_IDENTITY.copy()
    else:
        inp = inp.astype(np.float32) / 255.0
        if is_train and not cfg.dataset.no_color_aug:
            inp = color_aug(rng, inp)
        inp = (inp - np.asarray(cfg.dataset.mean, np.float32)) / np.asarray(
            cfg.dataset.std, np.float32
        )

    trans_out_rot = get_affine_transform(c, s, rot, (out_res, out_res))
    trans_out = get_affine_transform(c, s, 0.0, (out_res, out_res))

    hm = np.zeros((out_res, out_res, 1), dtype=np.float32)
    hm_hp = np.zeros((out_res, out_res, num_joints), dtype=np.float32)
    wh = np.zeros((max_objs, 2), dtype=np.float32)
    hps = np.zeros((max_objs, num_joints * 2), dtype=np.float32)
    reg = np.zeros((max_objs, 2), dtype=np.float32)
    ind = np.zeros((max_objs,), dtype=np.int32)
    reg_mask = np.zeros((max_objs,), dtype=np.float32)
    hps_mask = np.zeros((max_objs, num_joints * 2), dtype=np.float32)
    hp_offset = np.zeros((max_objs * num_joints, 2), dtype=np.float32)
    hp_ind = np.zeros((max_objs * num_joints,), dtype=np.int32)
    hp_mask = np.zeros((max_objs * num_joints,), dtype=np.float32)
    dense = {}
    if cfg.loss.dense_hp:
        dense["dense_hps"] = np.zeros(
            (out_res, out_res, num_joints * 2), dtype=np.float32
        )
        dense["dense_hps_mask"] = np.zeros(
            (out_res, out_res, num_joints * 2), dtype=np.float32
        )

    num_objs = min(len(anns), max_objs)

    # the geometry vectorised here, the per-object loop in C++; the Python
    # loop below is the fallback (and handles dense_hp)
    if num_objs > 0 and not cfg.loss.dense_hp and _try_native_encode(
        anns, num_objs, num_joints, out_res, width, flipped, rot,
        trans_out, trans_out_rot,
        dict(hm=hm, hm_hp=hm_hp, wh=wh, hps=hps, reg=reg, ind=ind,
             reg_mask=reg_mask, hps_mask=hps_mask, hp_offset=hp_offset,
             hp_ind=hp_ind, hp_mask=hp_mask),
    ):
        num_objs = 0  # filled natively: skip the Python loop

    for k in range(num_objs):
        ann = anns[k]
        x, y, w, h = [float(v) for v in ann["bbox"]]
        bbox = np.array([x, y, x + w, y + h], dtype=np.float32)
        pts = np.array(ann["keypoints"], np.float32).reshape(num_joints, 3)
        if flipped:
            bbox[[0, 2]] = width - bbox[[2, 0]] - 1
            pts[:, 0] = width - pts[:, 0] - 1
            for a, b in FLIP_IDX:
                tmp = pts[a].copy()
                pts[a] = pts[b]
                pts[b] = tmp

        corners = affine_transform_batch(bbox.reshape(2, 2), trans_out)
        bbox = np.clip(corners.reshape(4), 0, out_res - 1)
        bh, bw = bbox[3] - bbox[1], bbox[2] - bbox[0]
        if (bh <= 0 or bw <= 0) and rot == 0:
            continue

        radius = max(0, int(gaussian_radius((math.ceil(bh), math.ceil(bw)))))
        ct = np.array(
            [(bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0], dtype=np.float32
        )
        ct_int = ct.astype(np.int32)
        wh[k] = bw, bh
        ind[k] = ct_int[1] * out_res + ct_int[0]
        reg[k] = ct - ct_int
        reg_mask[k] = 1.0

        num_vis = (pts[:, 2] > 0).sum()
        if num_vis == 0:
            # Unannotated ("crowd"-ish) person: suppress the focal negative
            # penalty at its center by writing a near-1 target, but don't
            # regress to it.
            hm[ct_int[1], ct_int[0], 0] = 0.9999
            reg_mask[k] = 0.0

        hp_radius = radius
        for j in range(num_joints):
            if pts[j, 2] > 0:
                pj = affine_transform_batch(pts[j : j + 1, :2], trans_out_rot)[0]
                if 0 <= pj[0] < out_res and 0 <= pj[1] < out_res:
                    hps[k, j * 2 : j * 2 + 2] = pj - ct_int
                    hps_mask[k, j * 2 : j * 2 + 2] = 1.0
                    pj_int = pj.astype(np.int32)
                    hp_offset[k * num_joints + j] = pj - pj_int
                    hp_ind[k * num_joints + j] = pj_int[1] * out_res + pj_int[0]
                    hp_mask[k * num_joints + j] = 1.0
                    if cfg.loss.dense_hp:
                        dr = max(0, int(radius * 2 / 3))
                        _draw_dense_hp(
                            dense["dense_hps"],
                            dense["dense_hps_mask"],
                            j,
                            ct_int,
                            pj - ct_int,
                            dr,
                        )
                    draw_umich_gaussian(hm_hp[:, :, j], pj_int, hp_radius)
        draw_umich_gaussian(hm[:, :, 0], ct_int, radius)

    if rot != 0:
        # Rotated samples only regularize the backbone: mask all regression
        # losses and flatten the heatmap target (reference behavior).
        hm = hm * 0 + 0.9999
        hm_hp = hm_hp * 0 + 0.9999
        reg_mask *= 0
        hps_mask *= 0
        hp_mask *= 0

    if wire == "compact":
        # dense heatmaps ride H2D as f16 (values in [0,1]; <=5e-4 rel error,
        # cast back to f32 on device before the loss)
        hm = hm.astype(np.float16)
        hm_hp = hm_hp.astype(np.float16)
        dense = {k: v.astype(np.float16) for k, v in dense.items()}

    ret = {
        "input": inp,
        "hm": hm,
        "hm_hp": hm_hp,
        "wh": wh,
        **({"aug": aug_coeffs} if aug_coeffs is not None else {}),
        "hps": hps,
        "reg": reg,
        "ind": ind,
        "reg_mask": reg_mask,
        "hps_mask": hps_mask,
        "hp_offset": hp_offset,
        "hp_ind": hp_ind,
        "hp_mask": hp_mask,
        "c": c,
        "s": np.float32(s),
    }
    ret.update(dense)
    return ret


def _try_native_encode(anns, num_objs, num_joints, out_res, width, flipped,
                       rot, trans_out, trans_out_rot, out) -> bool:
    """Vectorise the per-object geometry and hand the fill loop to C++.
    Returns False, with ``out`` untouched, when the native library is
    unavailable."""
    if not native.available():
        return False
    bboxes = np.zeros((num_objs, 4), np.float32)
    pts = np.zeros((num_objs, num_joints, 3), np.float32)
    for k in range(num_objs):
        x, y, w, h = [float(v) for v in anns[k]["bbox"]]
        bboxes[k] = (x, y, x + w, y + h)
        pts[k] = np.array(anns[k]["keypoints"], np.float32).reshape(num_joints, 3)
    if flipped:
        bboxes[:, [0, 2]] = width - bboxes[:, [2, 0]] - 1
        pts[:, :, 0] = width - pts[:, :, 0] - 1
        for a, b in FLIP_IDX:
            pts[:, [a, b]] = pts[:, [b, a]]
    corners = affine_transform_batch(bboxes.reshape(-1, 2), trans_out)
    bboxes_t = np.clip(corners.reshape(num_objs, 4), 0, out_res - 1)
    joints_t = affine_transform_batch(
        pts[:, :, :2].reshape(-1, 2), trans_out_rot
    ).reshape(num_objs, num_joints, 2)
    vis = (pts[:, :, 2] > 0).astype(np.int32)
    return native.encode_targets_native(bboxes_t, joints_t, vis, out_res,
                                        rot != 0, out)


def _draw_dense_hp(dense_hps, dense_mask, j, ct_int, value, radius):
    """Splat a constant joint-displacement patch around the center cell."""
    h, w = dense_hps.shape[:2]
    x0, x1 = max(0, ct_int[0] - radius), min(w, ct_int[0] + radius + 1)
    y0, y1 = max(0, ct_int[1] - radius), min(h, ct_int[1] + radius + 1)
    dense_hps[y0:y1, x0:x1, 2 * j : 2 * j + 2] = value
    dense_mask[y0:y1, x0:x1, 2 * j : 2 * j + 2] = 1.0


def stack_batch(examples: list) -> Dict[str, np.ndarray]:
    """Stack per-example dicts into a batch dict of arrays."""
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples], axis=0) for k in keys}
