"""The step-ablation and input-pipeline tools
(``centerpose_tpu_torch/tools/ablate_step.py`` and
``bench_input_pipeline.py``) with ``--device cpu`` at 64x64: every row the
reference's tools write and the port's own are there and finite, the
launch counts are the CPU's (none: the plain versions run), and each
wire's bytes per image are the arithmetic of its tensors."""

import json
import math

import pytest

from centerpose_tpu_torch.tools import ablate_step, bench_input_pipeline

from _torch_port import release_compiled, release_resources  # noqa: F401

TINY = ["model.input_res", "64", "model.output_res", "16"]
# the rows tools/ablate_step.py writes
REFERENCE_ROWS = ("infer_full_ms", "infer_fwd_only_ms", "decode_ms",
                  "trunk_ms", "infer_fwd_convsub_ms", "dcn_total_cost_ms",
                  "agg_heads_ms", "train_full_ms", "train_convsub_ms",
                  "train_dcn_total_cost_ms")
PORT_ROWS = ("infer_fwd_unfused_om_ms", "om_fold_ms")


def test_busy_ms_is_the_union_of_the_spans():
    spans = [(10.0, 20.0), (0.0, 5.0), (15.0, 30.0), (16.0, 18.0),
             (40.0, 41.0)]
    assert ablate_step.busy_ms(spans) == pytest.approx(26.0 / 1e3)
    assert ablate_step.busy_ms([]) == 0.0


def test_ablate_step_rows_on_the_cpu(tmp_path):
    out = tmp_path / "ablation.json"
    rows = ablate_step.main(["--device", "cpu", "--batch", "2", "--iters",
                             "1", "--json", str(out), "--trace-dir",
                             str(tmp_path / "trace"), *TINY])
    assert json.loads(out.read_text()) == rows
    assert rows["batch"] == 2 and rows["card"] == "cpu"
    names = [r[:-3] for r in REFERENCE_ROWS + PORT_ROWS]
    assert set(names) == set(ablate_step.MEASURED) | set(ablate_step.DERIVED)
    for name in names:
        assert math.isfinite(rows[f"{name}_ms"]), name
        # no device to trace on the CPU: busy time is not measured
        assert rows[f"{name}_busy_ms"] is None, name
    for name in ablate_step.MEASURED:
        # the plain versions run on the CPU: no kernel is launched
        assert rows[f"{name}_launches"] == {"k1": 0.0, "k2": 0.0,
                                            "backward": 0.0}, name
    for name, (a, b) in ablate_step.DERIVED.items():
        assert rows[f"{name}_ms"] == rows[f"{a}_ms"] - rows[f"{b}_ms"]


def _wire_bytes_per_image(res: int, out: int, wire: str) -> int:
    """The bytes one encoded training example carries to the device
    (``data/encode.encode_example`` without the meta entries c, s): the
    image, the two heatmaps, and the per-object targets of K = 32 objects
    and J = 17 joints, at each wire's types."""
    k, j = 32, 17
    compact = wire == "compact"
    image = res * res * 3 * (1 if compact else 4)
    aug = 6 * 4 if compact else 0
    heatmaps = out * out * (1 + j) * (2 if compact else 4)
    per_object = 4 * (k * 2 + k * 2 * j + k * 2 + k + k + k * 2 * j
                      + k * j * 2 + k * j + k * j)
    return image + aug + heatmaps + per_object


def test_bench_input_pipeline_rows_on_the_cpu(tmp_path, monkeypatch):
    # one host core: the sweep's worker counts are {0, 1}
    monkeypatch.setattr(bench_input_pipeline.os, "cpu_count", lambda: 1)
    out = tmp_path / "pipeline.json"
    res = bench_input_pipeline.main([
        "--device", "cpu", "--images", "16", "--samples", "2", "--json",
        str(out), *TINY])
    assert json.loads(out.read_text()) == res
    assert res["host_cpus"] == 1 and res["card"] == "cpu"
    for key in ("raw_render_img_s", "encode_only_native_img_s",
                "encode_only_python_img_s"):
        assert math.isfinite(res[key]) and res[key] > 0, key
    sweep = {(r["num_workers"], r["encoder"]): r["loader_img_s"]
             for r in res["loader_sweep"]}
    assert set(sweep) == {(w, e) for w in (0, 1)
                          for e in ("native", "python")}
    assert all(math.isfinite(v) and v > 0 for v in sweep.values())
    for wire in ("float32", "compact"):
        row = res[f"prefetch_{wire}"]
        assert math.isfinite(row["prefetch_img_s"]), wire
        assert row["bytes_per_image"] == _wire_bytes_per_image(64, 16, wire)
        assert row["bytes_per_batch"] == 8 * row["bytes_per_image"]
    budget = res["budget"]
    assert budget["host_rate_img_s"] == max(sweep.values())
    assert math.isfinite(budget["per_core_img_s"])
    # the card's training rate is the card's: not taken on the CPU
    assert "card_train_img_s" not in budget and "card_train_img_s" not in res
