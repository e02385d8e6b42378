"""Pipelined detector evaluation, counterpart of
``centerpose_tpu/eval/harness.py``.

Three stages overlap:

1. host pre-process on a thread pool: each image's upload, resize and
   affine warp (``Detector.pre_process``, which queues its work on the
   device);
2. the forward and decode (``Detector.process``), asynchronous on the card:
   images of one input shape ride the device in batches of up to
   ``BUCKET_CAP``, and the scales of one image (fix_res warps every scale
   to ``input_res``) in one call;
3. on the main thread, a small in-flight queue is drained: the decoded
   rows are copied to the host (the sync point), inverse-affined and
   merged.

Used by the training CLI's in-training AP pass (``model_best`` is gated on
it) and as the pipelined counterpart of ``tools/evaluate.py``'s serial
loop.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from centerpose_tpu_torch.data.coco import read_image

STAGES = ("tot", "pre", "net", "post", "merge")
# images of one input shape per forward
BUCKET_CAP = 8


def evaluate_detector(
    detector,
    items: Iterable[Tuple[int, np.ndarray]],
    workers: int = 4,
    inflight: int = 4,
    progress: Optional[Callable[[int], None]] = None,
) -> Tuple[Dict[int, Dict[int, np.ndarray]], Dict[str, float], float]:
    """Run ``detector`` over ``items``, (img_id, RGB uint8 image or image
    file path) pairs; a path is decoded in the pre-process workers
    (``data/coco.read_image``).

    Returns (results by img_id, summed per-stage seconds, wall seconds).
    ``workers=0`` runs the serial ``detector.run`` loop instead."""
    times = dict.fromkeys(STAGES, 0.0)
    results: Dict[int, Dict[int, np.ndarray]] = {}
    t_start = time.perf_counter()

    if workers <= 0:
        for n, (img_id, im) in enumerate(items):
            ret = detector.run(im)
            results[img_id] = ret["results"]
            for k in times:
                times[k] += ret[k]
            if progress:
                progress(n + 1)
        return results, times, time.perf_counter() - t_start

    scales = detector.cfg.test.test_scales

    def preproc(task):
        img_id, im = task
        t0 = time.perf_counter()
        if isinstance(im, (str, os.PathLike)):
            im = read_image(os.fspath(im))
        if not isinstance(im, np.ndarray):
            raise TypeError("evaluate_detector takes [H, W, 3] numpy images "
                            "or image file paths")
        src = torch.from_numpy(np.ascontiguousarray(im)).to(detector.device)
        per_scale = [detector.pre_process(src, s) for s in scales]
        return img_id, per_scale, time.perf_counter() - t0

    def drain(entry):
        img_id, dets_devs, metas, t_disp = entry
        net_dt = post_dt = 0.0
        detections = []
        for dets_dev, meta, scale in zip(dets_devs, metas, scales):
            t0 = time.perf_counter()
            dets = dets_dev.cpu().numpy()  # the D2H sync for this image
            t1 = time.perf_counter()
            detections.append(detector.post_process(dets, meta, scale))
            net_dt += t1 - t0
            post_dt += time.perf_counter() - t1
        t2 = time.perf_counter()
        results[img_id] = detector.merge_outputs(detections)
        t3 = time.perf_counter()
        times["net"] += net_dt  # device wait and read-back
        times["post"] += post_dt
        times["merge"] += t3 - t2
        times["tot"] += t3 - t_disp

    n_done = 0
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pre_futs = deque()
        device_q = deque()
        pending = {}            # img_id -> dict(dets, metas, remaining, t)
        submit_order = deque()  # img_ids awaiting their forward, FIFO
        buckets = {}            # input shape -> [(img_id, scale_idx, images)]
        items_it = iter(items)

        def submit_more():
            # up to 2 * workers pre-process tasks in flight
            while len(pre_futs) < 2 * workers:
                try:
                    task = next(items_it)
                except StopIteration:
                    return False
                pre_futs.append(ex.submit(preproc, task))
            return True

        def flush_bucket(shape=None):
            for key in ([shape] if shape is not None else list(buckets)):
                entries = buckets.pop(key, None)
                if not entries:
                    continue
                dets_all = detector.process(torch.cat([e[2] for e in entries]))
                ofs = 0
                for img_id, si, images in entries:
                    k = images.shape[0]
                    pending[img_id]["dets"][si] = dets_all[ofs:ofs + k]
                    ofs += k
                    pending[img_id]["remaining"] -= 1

        def harvest_completed():
            while submit_order and pending[submit_order[0]]["remaining"] == 0:
                img_id = submit_order.popleft()
                ent = pending.pop(img_id)
                device_q.append((img_id, ent["dets"], ent["metas"], ent["t"]))

        more = submit_more()
        while pre_futs or device_q or submit_order:
            if pre_futs:
                # wait for the oldest pre-processed image; the device keeps
                # running the work queued before it
                img_id, per_scale, pre_dt = pre_futs.popleft().result()
                times["pre"] += pre_dt
                t_disp = time.perf_counter()
                shapes = {tuple(im.shape) for im, _ in per_scale}
                metas = [meta for _, meta in per_scale]
                if len(per_scale) > 1 and len(shapes) == 1:
                    # all scales of one image in one forward
                    dets_all = detector.process(
                        torch.cat([im for im, _ in per_scale]))
                    dets_devs = [dets_all[i:i + 1]
                                 for i in range(len(per_scale))]
                    device_q.append((img_id, dets_devs, metas, t_disp))
                else:
                    pending[img_id] = {"dets": [None] * len(per_scale),
                                       "metas": metas,
                                       "remaining": len(per_scale),
                                       "t": t_disp}
                    submit_order.append(img_id)
                    for si, (images, _) in enumerate(per_scale):
                        key = tuple(images.shape)
                        buckets.setdefault(key, []).append(
                            (img_id, si, images))
                        if len(buckets[key]) >= BUCKET_CAP:
                            flush_bucket(key)
                    # bound host memory: partial buckets must not starve
                    if len(submit_order) > max(inflight, BUCKET_CAP) * 2:
                        flush_bucket()
                    harvest_completed()
                if more:
                    more = submit_more()
            if not pre_futs:
                flush_bucket()
                harvest_completed()
            # drain device work beyond the in-flight window (all at the end)
            while len(device_q) > inflight or (not pre_futs and device_q):
                drain(device_q.popleft())
                n_done += 1
                if progress:
                    progress(n_done)
    return results, times, time.perf_counter() - t_start
