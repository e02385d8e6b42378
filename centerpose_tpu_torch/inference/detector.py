"""Inference pipeline: pre-process -> forward + decode -> post-process
-> merge.

Counterpart of ``centerpose_tpu/inference/detector.py``: per scale, a
bilinear resize and the fix_res affine warp to ``input_res`` (or keep_res
padded to ``test.pad_bucket``), uint8 normalisation on the device, optional
flip test as a batch of two, clamped sigmoid, decode at K = ``test.topk``,
host inverse affine; then the scales' detections are concatenated, merged
by soft-NMS under multi-scale or ``test.nms``, and the top K kept.

Everything up to the decoded [B, K, 40] rows runs on the device: the image
is uploaded as uint8 once and resized and warped there (no cv2).  ``run``
also takes an image file's path, decoded on the host with cv2
(``data/coco.read_image``).

With a ``mesh`` (``parallel/mesh.create_mesh_2d``), every rank of it holds
the same frames and the forward runs spatially sharded: each rank its
block of the batch and of the image rows (``parallel/spatial.py``), the
heads gathered back on every rank, then the decode as in one process.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from centerpose_tpu_torch.config import Config
from centerpose_tpu_torch.data.coco import read_image
from centerpose_tpu_torch.inference.post_process import multi_pose_post_process
from centerpose_tpu_torch.losses import sigmoid_clamped
from centerpose_tpu_torch.models.common import (to_channels_last,
                                                to_compute_dtype)
from centerpose_tpu_torch.models.factory import create_model, model_dtype
from centerpose_tpu_torch.ops.decode import multi_pose_decode
from centerpose_tpu_torch.ops.image import (FLIP_IDX, get_affine_transform,
                                            resize_linear, warp_affine)
from centerpose_tpu_torch.ops.soft_nms import soft_nms_39
from centerpose_tpu_torch.parallel.mesh import Mesh2D, spatial_sharding
from centerpose_tpu_torch.utils.platform import resolve_device
from centerpose_tpu_torch.weights import load_state_dict


def _flip_perm(n: int) -> list:
    perm = list(range(n))
    for a, b in FLIP_IDX:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_lr(x: torch.Tensor) -> torch.Tensor:
    """Flip a joint-channel map [B, H, W, 17] in W and swap L/R joints."""
    return x.flip(2)[..., _flip_perm(x.shape[-1])]


def flip_lr_off(x: torch.Tensor) -> torch.Tensor:
    """Flip a joint-offset map [B, H, W, 34] ((x, y) per joint): flip W,
    negate x, swap L/R joints."""
    b, h, w, c = x.shape
    j = c // 2
    x = x.flip(2).reshape(b, h, w, j, 2).clone()
    x[..., 0] *= -1.0
    return x[:, :, :, _flip_perm(j), :].reshape(b, h, w, c)


class ServingNet(nn.Module):
    """The device stage of serving as a module: [N, H, W, 3] uint8
    (normalised here) or float32 (already normalised) images -> decoded
    [N, K, 40] (grid coordinates).  Optional flip test as a batch of two
    (the flipped half built here), the forward, clamped sigmoid, decode at
    K = ``test.topk``.  It owns the model, and ``mean`` and ``std`` are
    buffers, so that an exported program (``tools/export.py``) holds them
    with the weights.  ``sharding``: a ``parallel/mesh.SpatialSharding``
    whose forward runs the model on row shards, or None."""

    def __init__(self, model: nn.Module, cfg: Config, sharding=None):
        super().__init__()
        self.model = model
        self.sharding = sharding
        self.register_buffer("mean", torch.tensor(cfg.dataset.mean,
                                                  dtype=torch.float32))
        self.register_buffer("std", torch.tensor(cfg.dataset.std,
                                                 dtype=torch.float32))
        self.flip_test = cfg.test.flip_test
        self.k = cfg.test.topk
        self.loss = cfg.loss

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0 - self.mean) / self.std
        if self.flip_test:
            images = torch.cat([images, images.flip(2)], dim=0)
        out = (self.model(images) if self.sharding is None
               else self.sharding.forward(self.model, images))
        hm = sigmoid_clamped(out["hm"])
        hm_hp = sigmoid_clamped(out["hm_hp"]) if self.loss.hm_hp else None
        wh, hps = out["wh"], out["hps"]
        reg = out["reg"] if self.loss.reg_offset else None
        hp_offset = out["hp_offset"] if self.loss.reg_hp_offset else None
        if self.flip_test:
            n = images.shape[0] // 2
            hm = (hm[:n] + hm[n:].flip(2)) / 2.0
            wh = (wh[:n] + wh[n:].flip(2)) / 2.0
            hps = (hps[:n] + flip_lr_off(hps[n:])) / 2.0
            if hm_hp is not None:
                hm_hp = (hm_hp[:n] + flip_lr(hm_hp[n:])) / 2.0
            if reg is not None:
                reg = reg[:n]
            if hp_offset is not None:
                hp_offset = hp_offset[:n]
        return multi_pose_decode(hm, wh, hps, reg, hm_hp, hp_offset, k=self.k)


class Detector:
    """Single-image / batched inference engine.

    ``state_dict``: model weights (``weights.state_dict_from_npz``); None
    keeps the random initialisation, seeded with 0.  ``device``: the card
    unless the caller asks for ``"cpu"``.  ``mesh``: a (data, spatial)
    mesh of the ranks serving together, each holding the same frames (the
    forward is sharded over it), or None."""

    def __init__(self, cfg: Config, state_dict: Optional[dict] = None,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh2D] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = create_model(cfg)
        if state_dict is not None:
            load_state_dict(model, state_dict)
        self.model = to_channels_last(to_compute_dtype(
            model.to(self.device), model_dtype(cfg))).eval()
        sharding = None if mesh is None else spatial_sharding(mesh)
        self.net = ServingNet(self.model, cfg, sharding).to(
            self.device).eval()
        self.mean, self.std = self.net.mean, self.net.std
        self.k = cfg.test.topk

    # ------------------------------------------------------------------
    # device stage
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def process(self, images: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 (normalised here) or float32 (already
        normalised) on the device -> decoded [N, K, 40] (``ServingNet``)."""
        return self.net(images)

    # ------------------------------------------------------------------
    # host stages
    # ------------------------------------------------------------------
    def pre_process(self, image, scale: float = 1.0):
        """Resize one [H, W, 3] image by ``scale`` and affine-warp it on the
        device; returns ([1, h, w, 3] uint8 on the device, meta).  ``image``
        is a numpy array or a tensor already on the device (``run``
        uploads once for all scales).  A float image (0-255 pixel values)
        is normalised here and returned as float32."""
        height, width = image.shape[0:2]
        new_height, new_width = int(height * scale), int(width * scale)
        if self.cfg.test.keep_res:
            bucket = max(32, self.cfg.test.pad_bucket)
            inp_height = (new_height + bucket - 1) // bucket * bucket
            inp_width = (new_width + bucket - 1) // bucket * bucket
            c = np.array([new_width // 2, new_height // 2], dtype=np.float32)
            s = np.array([inp_width, inp_height], dtype=np.float32)
        else:
            inp_height = inp_width = self.cfg.model.input_res
            c = np.array([new_width / 2.0, new_height / 2.0], dtype=np.float32)
            s = max(height, width) * 1.0
        trans = get_affine_transform(c, s, 0.0, (inp_width, inp_height))
        src = image
        if isinstance(image, np.ndarray):
            src = torch.from_numpy(np.ascontiguousarray(image))
        src = resize_linear(src.to(self.device), (new_width, new_height))
        warped = warp_affine(src, trans, (inp_width, inp_height))
        inp = warped
        if src.dtype != torch.uint8:
            inp = (warped / 255.0 - self.mean) / self.std
        down = self.cfg.model.input_res // self.cfg.model.output_res
        meta = {"c": c, "s": s, "out_height": inp_height // down,
                "out_width": inp_width // down}
        return inp[None], meta

    def post_process(self, dets: np.ndarray, meta: dict,
                     scale: float = 1.0) -> Dict[int, np.ndarray]:
        """[1, K, 40] grid coords -> {1: [K, 39]} original-image pixels
        (box and joints divided by ``scale``)."""
        out = multi_pose_post_process(dets, [meta["c"]], [meta["s"]],
                                      meta["out_height"], meta["out_width"])
        res = out[0][1]
        if scale != 1.0:
            res[:, :4] /= scale
            res[:, 5:] /= scale
        return {1: res}

    def merge_outputs(self, detections: List[Dict[int, np.ndarray]]
                      ) -> Dict[int, np.ndarray]:
        """Concatenate the scales' rows (float32); soft-NMS (Gaussian,
        nt 0.5) under multi-scale or ``test.nms``; keep the top K by
        score."""
        rows = np.concatenate([d[1] for d in detections],
                              axis=0).astype(np.float32)
        if self.cfg.test.nms or len(self.cfg.test.test_scales) > 1:
            rows = soft_nms_39(rows, nt=0.5, method=2)
        keep = np.argsort(-rows[:, 4])[: self.k]
        return {1: rows[keep]}

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def run(self, image) -> Dict:
        """Full pipeline on one RGB [H, W, 3] image, or an image file's
        path (decoded as the reference does: ``data/coco.read_image``),
        over ``test.test_scales``; returns the results and per-stage wall
        times (seconds, device work synchronised): ``load`` the decode of
        a path, ``pre`` the one upload and each scale's resize and warp,
        ``net``, ``post``, ``merge`` and ``tot``."""
        t_start = time.perf_counter()
        if isinstance(image, (str, os.PathLike)):
            image = read_image(os.fspath(image))
        if not isinstance(image, np.ndarray):
            raise TypeError("Detector.run takes an [H, W, 3] numpy image or "
                            "an image file's path")
        t_load = time.perf_counter()
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        src = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        detections = []
        pre_t = net_t = post_t = 0.0
        t0 = t_load
        for scale in self.cfg.test.test_scales:
            images, meta = self.pre_process(src, scale)
            sync()
            t1 = time.perf_counter()
            dets = self.process(images).cpu().numpy()  # the one D2H copy
            t2 = time.perf_counter()
            detections.append(self.post_process(dets, meta, scale))
            t3 = time.perf_counter()
            pre_t += t1 - t0
            net_t += t2 - t1
            post_t += t3 - t2
            t0 = t3
        t4 = time.perf_counter()
        results = self.merge_outputs(detections)
        t_end = time.perf_counter()
        return {"results": results, "tot": t_end - t_start,
                "load": t_load - t_start, "pre": pre_t, "net": net_t,
                "post": post_t, "merge": t_end - t4}

    def run_batch(self, images: np.ndarray) -> np.ndarray:
        """Batched frames [N, H, W, 3] -> decoded [N, K, 40] (grid coords).
        uint8 frames are normalised on the device; float32 frames are taken
        as already normalised.  The caller does any inverse affine."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return self.process(x).cpu().numpy()
