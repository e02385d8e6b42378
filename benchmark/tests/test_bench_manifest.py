"""The manifest's names, units and files, and that a configuration, a
traffic mix, a cell and a per-layer metric are added by new files and
entries alone."""

import json
import shutil

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness.trace import Trace


@pytest.fixture(scope="module")
def m():
    return mf.Manifest()


def test_no_problems(m):
    assert mf.problems(m) == []


def test_names_and_units(m):
    d = m.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in d[group]:
            assert mf.NAME.fullmatch(e["name"]), e["name"]
    for e in d["end_to_end"] + d["per_layer"]:
        assert mf.UNIT.fullmatch(e["unit"]), e["unit"]
        assert 1 <= len(e["unit"]) <= 16
    for e in d["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


def test_files_found_by_name(m):
    for cell in m.workloads.values():
        assert m.config(cell)["name"] == cell["config"]
        assert m.driver(m.traffic(cell)["kind"]).run
        assert m.limits(cell)
    for name in m.per_layer:
        assert callable(m.reader(name).read)


def test_moves_reported(m):
    """Every cell that reports a per-layer metric reports the end-to-end
    metric it moves, and every cell reports setup_s and one more."""
    for cell in m.workloads.values():
        e2e = {x["name"] for x in m.e2e_metrics(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = m.layer_metrics(cell)
        assert layer
        for metric in layer:
            assert metric["moves"] in e2e, (cell["name"], metric["name"])


def test_layers_named_alike(m):
    """Metrics of one layer give it letter for letter."""
    layers = {x["layer"] for x in m.data["per_layer"]}
    assert layers <= {"device", "serving step", "training step",
                      "DCN kernels"}


def test_roofline_shares_named(m):
    for x in m.data["per_layer"]:
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_added_by_files_alone(tmp_path, m):
    """A dummy configuration, traffic mix, cell and per-layer metric, added
    to a copy as new files and manifest entries, are found by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(mf.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    data = json.loads(mf.MANIFEST.read_text())
    cfg = json.loads((mf.ROOT / data["configs"][0]["file"]).read_text())
    cfg["name"] = "dummy-cfg"
    (bench / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"kind": "stream", "batch": 1}))
    (bench / "limits" / "dummy-cell.json").write_text(
        json.dumps({"score": 1.0}))
    (bench / "metrics" / "dummy_ms.serve.py").write_text(
        "def read(trace, info):\n    return trace.items * 2.0\n")
    data["configs"].append({"name": "dummy-cfg", "source": "https://x.org",
                            "file": "benchmark/configs/dummy-cfg.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "dummy-cell", "config": "dummy-cfg",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a test"})
    moved = data["end_to_end"][0]
    moved.setdefault("workloads", []).append("dummy-cell")
    data["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": moved["name"],
                              "workloads": ["dummy-cell"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    m2 = mf.Manifest(path, bench)
    assert mf.problems(m2) == []
    cell = m2.cell("dummy-cell")
    assert m2.config(cell)["name"] == "dummy-cfg"
    assert m2.traffic(cell)["batch"] == 1
    assert m2.limits(cell) == {"score": 1.0}
    assert [x["name"] for x in m2.layer_metrics(cell)] == ["dummy_ms.serve"]
    assert m2.reader("dummy_ms.serve").read(Trace(items=3), {}) == 6.0
    assert m2.driver("stream").run
