"""The port's demo (``tools/demo.py``): its batched video stream against
the body of the reference's ``run_video`` (``Detector.pre_process`` ->
one ``run_batch`` per batch -> ``multi_pose_post_process`` per frame) on
the same frames and weights (dla_34 @128, float32, ``xla``, the snapshot,
on the CPU), and its command line on images, ``synthetic`` and a video."""

import os

import cv2
import numpy as np
import pytest

from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu.inference.post_process import (
    multi_pose_post_process as ref_post)
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools import demo
from centerpose_tpu_torch.weights import state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ, jax_cfg, jax_variables, torch_cfg

# the demo CLI on the CPU at 128x128: the flagship config in float32 under
# the xla policy (the bf16 pallas_full default runs too, only slower here)
CLI = ["--device", "cpu", "model.input_res", "128", "model.output_res", "32",
       "model.compute_dtype", "float32", "model.dcn_impl", "xla"]


def _frames(n: int = 5):
    from centerpose_tpu_torch.data.synthetic import render_scene

    return [render_scene(np.random.default_rng(40 + i), 320, 240, 2)[0]
            for i in range(n)]


def _reference_stream(frames):
    """The body of the reference's ``run_video`` on RGB frames, all in one
    batch (one compile of its jitted forward)."""
    det = JaxDetector(jax_cfg(128), variables=jax_variables())
    pre = [det.pre_process(f) for f in frames]
    dets = det.run_batch(np.concatenate([p[0] for p in pre], axis=0))
    return [ref_post(dets[bi:bi + 1], [meta["c"]], [meta["s"]],
                     meta["out_height"], meta["out_width"])[0][1]
            for bi, (_, meta) in enumerate(pre)]


def test_stream_matches_reference_run_video():
    frames = _frames(5)
    det = Detector(torch_cfg(128), state_dict_from_npz(NPZ), device="cpu")
    calls = []
    real = det.process

    def counted(images):
        calls.append(tuple(images.shape))
        return real(images)

    det.process = counted
    got = list(demo.stream(det, iter(frames), 2))
    # 3 process calls, the last with the one frame left
    assert calls == [(2, 128, 128, 3), (2, 128, 128, 3), (1, 128, 128, 3)]
    want = _reference_stream(frames)
    assert len(got) == len(want) == 5
    for (frame, rows), f, w in zip(got, frames, want):
        assert frame is f
        assert rows.shape == w.shape == (100, 39)
        # tests/test_torch_detector.py's tolerance for whole runs
        np.testing.assert_allclose(rows, w, rtol=1e-3, atol=2e-2)


def _stage_lines(out: str, names):
    lines = [ln for ln in out.splitlines() if ": tot " in ln]
    assert [ln.split(":")[0] for ln in lines] == list(names), out
    for ln in lines:
        for stage in ("pre", "net", "post", "merge"):
            assert f" {stage} " in ln, ln
    return lines


def test_demo_cli_synthetic_and_directory(tmp_path, capsys):
    out = tmp_path / "syn"
    ret = demo.main(["--demo", "synthetic", "--out", str(out), *CLI])
    names = [f"synthetic_{i}" for i in range(4)]
    assert ret == {"images": names}
    _stage_lines(capsys.readouterr().out, names)
    for n in names:
        img = cv2.imread(str(out / f"{n}.png"))
        assert img is not None and img.shape == (480, 640, 3)
    src = tmp_path / "imgs"
    src.mkdir()
    for i, f in enumerate(_frames(2)):
        cv2.imwrite(str(src / f"frame_{i}.png"), f[..., ::-1])
    (src / "notes.txt").write_text("not an image")
    out = tmp_path / "dir"
    ret = demo.main(["--demo", str(src), "--out", str(out), *CLI])
    assert ret == {"images": ["frame_0", "frame_1"]}
    _stage_lines(capsys.readouterr().out, ["frame_0", "frame_1"])
    assert sorted(os.listdir(out)) == ["frame_0.png", "frame_1.png"]


def test_demo_cli_video(tmp_path, capsys):
    path = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (320, 240))
    if not writer.isOpened():  # no mp4v encoder: MJPG in an .avi
        path = str(tmp_path / "in.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24,
                                 (320, 240))
    for f in _frames(5):
        writer.write(f[..., ::-1].copy())
    writer.release()
    out = tmp_path / "vid"
    ret = demo.main(["--demo", path, "--out", str(out), "--batch", "2", *CLI])
    assert ret == {"frames": 5}
    assert "5 frames in " in capsys.readouterr().out
    cap = cv2.VideoCapture(str(out / "out.mp4"))
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 5


def test_demo_refuses_what_it_cannot_open(tmp_path):
    with pytest.raises(SystemExit, match="cannot open"):
        demo.main(["--demo", str(tmp_path / "missing.mp4"), "--out",
                   str(tmp_path), *CLI])
