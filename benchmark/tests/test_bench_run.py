"""A run of the harness at a small size on the CPU: what it loads, what
it prints, and that a broken timed path comes out not correct."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import guard
from benchmark.harness.manifest import MANIFEST, ROOT, Manifest
from benchmark.tests import faults, small

CELLS = ["dla34-stream-b8", "hrnet32-stream-b8"]


def drive(cell, **kw):
    return run.execute(small.context(cell, **kw), Manifest())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = drive(cell, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) <= {m["name"] for m in
                                    Manifest().per_layer.values()}
    assert line["breakdown"]["device_ops"]


def test_no_forbidden_module_loaded():
    """A whole run loads no module of JAX or of the JAX package, names
    compared whole (the port's package passes)."""
    code = ("import sys, torch; torch.set_num_threads(2); "
            "from benchmark.tests.test_bench_run import drive; "
            "drive('dla34-stream-b8'); "
            "from benchmark.harness import guard; "
            "print(guard.forbidden_loaded()); "
            "assert 'centerpose_tpu_torch' in sys.modules; "
            "sys.exit(1 if guard.forbidden_loaded() else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


def test_guard_compares_whole_names():
    assert guard.forbidden_loaded(["centerpose_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["centerpose_tpu.models", "jax.numpy",
                                   "flax"]) == ["centerpose_tpu", "flax",
                                                "jax"]


def test_no_chip_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "2200000000", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    shutil.copy(MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


# faults planted in the timed path, each of which a stream cell can have
def _half_batch(orig):
    def broken(self, images):
        half = orig(self, images[: len(images) // 2])
        return np.concatenate([half, half])[: len(images)]
    return broken


def _altered_box(orig):
    def broken(self, images):
        rows = orig(self, images).copy()
        rows[-1, 0, :4] = rows[-1, 1, :4]  # the next row's box
        return rows
    return broken


def _altered_score(orig):
    def broken(self, images):
        rows = orig(self, images).copy()
        rows[0, 1, 4] *= 0.5
        return rows
    return broken


def _stale(orig):
    state = {}

    def broken(self, images):
        rows = state.get("rows")
        state["rows"] = orig(self, images)
        return state["rows"] if rows is None else rows
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered_box,
                                   _altered_score, _stale])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from centerpose_tpu_torch.inference.detector import Detector

    monkeypatch.setattr(Detector, "run_batch", fault(Detector.run_batch))
    line = drive(CELLS[0], seconds=0.5)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.DECODE))
def test_broken_decode_is_not_correct(fault):
    """A decode that selects the wrong rows (no NMS, a top K cut or
    reordered below the shown score) or never snaps a joint."""
    with faults.decode_fault(fault):
        line = drive(CELLS[0], seconds=0.5)
    assert not line["correct"], line["checks"]
