"""Demo CLI, counterpart of ``tools/demo.py``.

    python -m centerpose_tpu_torch.tools.demo --demo img.jpg
    python -m centerpose_tpu_torch.tools.demo --demo images_dir/ --out vis/
    python -m centerpose_tpu_torch.tools.demo --demo video.mp4 --batch 8
    python -m centerpose_tpu_torch.tools.demo --demo webcam
    python -m centerpose_tpu_torch.tools.demo --demo synthetic

with ``[--cfg FILE | --defaults] [--device cpu] [KEY VALUE ...]`` as in the
port's other CLIs: without ``--cfg`` the flagship config (dla_34 @512,
bfloat16, ``pallas_full``), weights from ``test.model_path`` through
``tools/evaluate.load_detector`` (an ``.npz`` snapshot, by default the
committed dla_34 one, or a training checkpoint).

Images (a file, a directory's image files, or ``synthetic``: 4 rendered
640x480 scenes, ``data/synthetic.render_scene``) go one at a time through
``Detector.run``; each is drawn with ``utils/debugger.Debugger`` into
``--out/<name>.png`` and its stage times printed.  A video file or the
webcam goes through ``stream``: ``--batch`` frames pre-processed on the
device, one ``Detector.process`` call and one device-to-host copy per
batch, the inverse affine per frame on the host; the drawn frames are
written to ``--out/out.mp4`` (mp4v, 24 fps).  cv2 decodes, draws and
writes (imported where it is used); the device path needs none of it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from centerpose_tpu_torch.data.coco import read_image
from centerpose_tpu_torch.data.synthetic import render_scene
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools.evaluate import (load_detector, no_tf32,
                                                 run_config)
from centerpose_tpu_torch.utils.debugger import Debugger

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch demo")
    p.add_argument("--cfg", type=str, default=None,
                   help="experiment yaml (default: the flagship, in code)")
    p.add_argument("--defaults", action="store_true",
                   help="without --cfg: start from the config defaults, "
                        "not the flagship")
    p.add_argument("--demo", type=str, required=True,
                   help="image / image dir / video file / 'webcam' / "
                        "'synthetic'")
    p.add_argument("--out", type=str, default="demo_out")
    p.add_argument("--batch", type=int, default=8, help="video batch size")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", nargs="*", help="KEY VALUE config override pairs")
    return p.parse_args(argv)


def synthetic_frames(n: int = 4) -> List[Tuple[str, np.ndarray]]:
    """``n`` rendered 640x480 RGB scenes of 2 people, scene i from seed i."""
    return [(f"synthetic_{i}",
             render_scene(np.random.default_rng(i), 640, 480, 2)[0])
            for i in range(n)]


def image_frames(demo: str) -> List[Tuple[str, np.ndarray]]:
    """(name, RGB image) of an image file or of a directory's image files
    in name order."""
    if os.path.isdir(demo):
        files = [os.path.join(demo, f) for f in sorted(os.listdir(demo))
                 if f.lower().endswith(IMG_EXTS)]
    else:
        files = [demo]
    return [(os.path.splitext(os.path.basename(f))[0], read_image(f))
            for f in files]


def stream(detector: Detector, frames: Iterable[np.ndarray],
           batch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batched inference over RGB frames [H, W, 3]: yields (frame, its
    detections [K, 39] in frame pixels) in order.  Each batch of up to
    ``batch`` frames (the last may be shorter) is pre-processed on the
    detector's device, concatenated into one [N, h, w, 3] uint8 tensor, run
    through one ``Detector.process`` call and copied to the host once; the
    inverse affine runs per frame."""
    it = iter(frames)
    while True:
        chunk = list(itertools.islice(it, batch))
        if not chunk:
            return
        pre = [detector.pre_process(f) for f in chunk]
        images = torch.cat([p[0] for p in pre])
        dets = detector.process(images).cpu().numpy()  # the one D2H copy
        for bi, (frame, (_, meta)) in enumerate(zip(chunk, pre)):
            yield frame, detector.post_process(dets[bi:bi + 1], meta)[1]


def video_frames(cap) -> Iterator[np.ndarray]:
    """The RGB frames of an open ``cv2.VideoCapture``, until it ends."""
    import cv2

    while True:
        ok, frame = cap.read()
        if not ok:
            return
        yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


def run_video(args, cfg, detector: Detector) -> int:
    """The video file ``args.demo`` (or the webcam) through ``stream`` at
    ``args.batch``, drawn into ``args.out/out.mp4``; returns the frame
    count."""
    import cv2

    cap = cv2.VideoCapture(0 if args.demo == "webcam" else args.demo)
    if not cap.isOpened():
        raise SystemExit(f"cannot open {args.demo}")
    path = os.path.join(args.out, "out.mp4")
    writer = None
    n_frames = 0
    t0 = time.perf_counter()
    try:
        for frame, rows in stream(detector, video_frames(cap), args.batch):
            dbg = Debugger()
            dbg.add_img(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR), "f")
            dbg.add_multi_pose(rows, cfg.test.vis_thresh, "f")
            vis = dbg.imgs["f"]
            if writer is None:
                writer = cv2.VideoWriter(
                    path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                    (vis.shape[1], vis.shape[0]))
            writer.write(vis)
            n_frames += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    wall = time.perf_counter() - t0
    print(f"{n_frames} frames in {wall:.1f}s -> {n_frames / wall:.1f} FPS; "
          f"saved {path}")
    return n_frames


def main(argv=None) -> Dict:
    """Run the demo; returns ``{"images": [names drawn]}`` or, for a
    video, ``{"frames": count}``."""
    args = parse_args(argv)
    no_tf32()
    cfg = run_config(args.cfg, args.opts, args.defaults)
    detector = load_detector(cfg, args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.demo == "synthetic":
        frames = synthetic_frames()
    elif os.path.isdir(args.demo) or args.demo.lower().endswith(IMG_EXTS):
        frames = image_frames(args.demo)
    else:
        return {"frames": run_video(args, cfg, detector)}
    import cv2

    for name, img in frames:
        ret = detector.run(img)
        dbg = Debugger()
        dbg.add_img(cv2.cvtColor(img, cv2.COLOR_RGB2BGR), name)
        dbg.add_multi_pose(ret["results"][1], cfg.test.vis_thresh, name)
        dbg.save_all_imgs(args.out)
        print(f"{name}: tot {1000 * ret['tot']:.1f}ms | pre "
              f"{1000 * ret['pre']:.1f} net {1000 * ret['net']:.1f} post "
              f"{1000 * ret['post']:.1f} merge {1000 * ret['merge']:.1f}",
              flush=True)
    print(f"saved visualizations to {args.out}/")
    return {"images": [name for name, _ in frames]}


if __name__ == "__main__":
    main()
