"""The port's training CLI (``tools/train.py``) end to end on the CPU at
64x64, with a resume, and the pipelined evaluation harness that its AP pass
runs, against the serial ``Detector.run`` loop."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from centerpose_tpu_torch.data.loader import DataLoader
from centerpose_tpu_torch.data.synthetic import (SyntheticEvalDataset,
                                                 SyntheticPoseDataset)
from centerpose_tpu_torch.eval.harness import evaluate_detector
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools import train as train_cli
from centerpose_tpu_torch.train.checkpoints import to_host
from centerpose_tpu_torch.weights import state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ, bit_equal, torch_cfg

OPTS = ["model.input_res", "64", "model.output_res", "16",
        "train.batch_size", "4", "train.num_workers", "0",
        "train.val_intervals", "1", "train.val_ap_limit", "2",
        "train.lr_step", "[1]", "dataset.max_objs", "8"]


def test_cli_trains_saves_validates_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["--synthetic", "--hard", "--synthetic-size", "8", "--device",
            "cpu", *OPTS, "output_dir", str(tmp_path), "exp_id", "t"]
    run1 = train_cli.main(argv + ["train.epochs", "1"])
    log_dir = Path(run1["log_dir"])
    assert log_dir == tmp_path / "t"
    for name in ("log.txt", "scalars.jsonl", "model_last",
                 "model_last.meta.json", "model_best", "model_best.meta.json"):
        assert (log_dir / name).is_file(), name
    tags = [json.loads(x)["tag"] for x in
            (log_dir / "scalars.jsonl").read_text().splitlines()]
    for tag in ("train/loss", "train/data_wait_frac", "val/loss", "val_ap/AP"):
        assert tag in tags, tag
    live = run1["trainer"]
    assert live.step == 2 and np.isfinite(run1["first_loss"])
    assert json.loads((log_dir / "model_last.meta.json").read_text())[
        "dcn_impl"] == "pallas_full"

    run2 = train_cli.main(argv + ["train.epochs", "2", "train.resume", "1"])
    assert run2["start_epoch"] == 1
    assert [e["epoch"] for e in run2["epochs"]] == [2]
    assert "resumed from" in (log_dir / "log.txt").read_text()
    assert bit_equal(run2["restored"], to_host(live.state()))
    assert run2["restored"]["optimizer"]["updates"] == 2
    # the resumed run's first step gives the live trainer's loss on the
    # same batch (epoch 2's first), bit for bit
    cfg = train_cli.run_config(None, OPTS)  # the config main() built
    first = next(DataLoader(SyntheticPoseDataset(8, seed=1, hard=True), cfg,
                            4, seed=cfg.train.seed).epoch(2))
    assert float(live.train_step(first)["loss"]) == run2["first_loss"]
    assert run2["trainer"].step == 4


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """``--multihost`` outside torchrun's environment is refused (never
    run quietly in one process: ``tests/test_torch_parallel_cli.py`` runs
    it on two ranks); without ``--synthetic`` the CLI reads COCO files,
    and a tree without them is refused naming the file it looked for."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        train_cli.main(["--synthetic", "--multihost", "--device", "cpu"])
    with pytest.raises(FileNotFoundError,
                       match="person_keypoints_train2017.json"):
        train_cli.main(["--device", "cpu", "--defaults", "dataset.root",
                        str(tmp_path), "output_dir", str(tmp_path / "out")])


@pytest.mark.parametrize("test", [{}, {"flip_test": True,
                                       "test_scales": (0.75, 1.0, 1.25)}])
def test_pipelined_harness_equals_serial(test):
    det = Detector(torch_cfg(128, "pallas_full", test=test),
                   state_dict_from_npz(NPZ), device="cpu")
    items = list(SyntheticEvalDataset(4, seed=3, hard=True).items())
    serial, stimes, _ = evaluate_detector(det, items, workers=0)
    piped, ptimes, _ = evaluate_detector(det, iter(items), workers=2,
                                         inflight=1)
    assert serial.keys() == piped.keys() == {0, 1, 2, 3}
    for img_id in serial:
        a, b = serial[img_id][1], piped[img_id][1]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        if test:
            # an image's scales ride one forward in both paths
            assert np.array_equal(a, b)
        # single scale: 4 images in one forward against 4 forwards of one,
        # whose f32 conv sums differ in the last bits (1.2e-4 px here)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert all(ptimes[k] > 0 for k in ("pre", "net", "post", "merge"))
