"""The bench tools (``centerpose_tpu_torch/tools/bench_suite.py`` and
``bench_eval.py``): the table's upsert and sort against the reference's,
and each row kind at 64x64 on the CPU with the reference's keys plus
``card``."""

import importlib.util
import json
import sys
import types
from pathlib import Path

import pytest

from centerpose_tpu_torch.tools import bench_eval, bench_suite

from _torch_port import release_compiled, release_resources  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["model.input_res", "64", "model.output_res", "16"]
KEYS = {"infer": {"arch", "variant", "mode", "batch", "ms_per_batch",
                  "images_per_s"},
        "train": {"arch", "variant", "mode", "batch", "ms_per_step",
                  "images_per_s"}}


def _row(arch, variant, mode, batch, ms):
    return {"arch": arch, "variant": variant, "mode": mode, "batch": batch,
            "ms_per_batch": ms, "images_per_s": batch * 1e3 / ms}


OLD = [_row("res_18", "bfloat16", "infer", 8, 10.0),
       _row("dla_34", "pallas_full/bfloat16", "infer", 1, 5.0),
       _row("mobilenetv3", "bfloat16", "video", 8, 7.0),
       _row("dla_34", "conv/bfloat16", "infer", 1, 4.0)]
NEW = [_row("res_18", "bfloat16", "infer", 8, 11.0),
       _row("res_18", "bfloat16", "infer", 1, 3.0),
       _row("dla_34", "pallas_full/bfloat16", "infer", 1, 6.0),
       _row("dla_34", "pallas_full/bfloat16", "infer", 1, 6.5),
       _row("hrnet_w32", "bfloat16/serial", "eval_msflip", 1, 90.0)]


def _reference_merge(tmp_path, monkeypatch, old, new):
    """The reference's ``tools/bench_eval.py`` ``main`` merging ``new``
    into a table file holding ``old`` (its measurements and its
    ``output/PERF.md`` writer stubbed; run in ``tmp_path``)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(sys.modules, "bench_suite", types.SimpleNamespace(
        write_perf_md=lambda table: None))
    spec = importlib.util.spec_from_file_location(
        "reference_bench_eval", ROOT / "tools" / "bench_eval.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(ref, "bench_video", lambda frames: new[:2])
    monkeypatch.setattr(ref, "bench_msflip_eval", lambda n: new[2:])
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "table.json"
    path.write_text(json.dumps(old))
    monkeypatch.setattr(sys, "argv", ["bench_eval.py", "--json", str(path)])
    ref.main()
    return json.loads(path.read_text())


def test_merge_matches_reference_table(tmp_path, monkeypatch):
    want = _reference_merge(tmp_path, monkeypatch, OLD, NEW)
    got = bench_suite.merge_rows(OLD, NEW)
    assert got == want
    assert len(got) == 6  # the repeated key: the last row wins
    path = tmp_path / "port" / "bench_table.json"
    bench_suite.write_table(got, str(path))
    assert bench_suite.read_table(str(path)) == got
    md = (tmp_path / "port" / "bench_table.md").read_text()
    assert md.count("\n| ") == 1 + len(got)  # the header and a row each


@pytest.mark.parametrize("arch", ["res_18", "dla_34"])
def test_suite_rows_on_cpu(tmp_path, arch):
    rows = bench_suite.run([arch], ["infer", "train"], batches=[1],
                           train_batch_size=2, iters=1, device="cpu",
                           opts=SMALL)
    variant = "pallas_full/bfloat16" if arch == "dla_34" else "bfloat16"
    assert [(r["mode"], r["batch"], r["variant"]) for r in rows] == [
        ("infer", 1, variant), ("train", 2, variant)]
    for row in rows:
        assert set(row) == KEYS[row["mode"]] | {"card"}
        assert row["card"] == "cpu" and row["images_per_s"] > 0
    path = tmp_path / "bench_table.json"
    bench_suite.write_table(bench_suite.merge_rows([], rows), str(path))
    md = path.with_suffix(".md").read_text()
    assert md.startswith("# Per-backbone performance (cpu)")
    assert f"| {arch} | {variant} | train | 2 |" in md


def test_eval_rows_on_cpu():
    rows = (bench_eval.bench_video(4, batch=2, device="cpu", opts=SMALL)
            + bench_eval.bench_msflip_eval(2, device="cpu", opts=SMALL))
    assert [(r["arch"], r["variant"], r["mode"]) for r in rows] == [
        ("mobilenetv3", "bfloat16", "video"),
        ("hrnet_w32", "bfloat16/serial", "eval_msflip"),
        ("hrnet_w32", "bfloat16/pipelined", "eval_msflip")]
    extra = {"h2d_GBps", "h2d_bytes_per_image", "card"}
    assert set(rows[0]) == KEYS["infer"] | extra
    assert rows[0]["h2d_bytes_per_image"] == 64 * 64 * 3
    for row in rows[1:]:
        assert set(row) == KEYS["infer"] | extra | {"stage_times_s"}
        assert set(row["stage_times_s"]) == {"tot", "pre", "net", "post",
                                             "merge"}
        assert row["h2d_bytes_per_image"] == 640 * 480 * 3
    assert all(r["h2d_GBps"] is None and r["images_per_s"] > 0
               for r in rows)
