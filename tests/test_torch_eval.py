"""The evaluation slice as a whole: the port's scenes, Detector, detection
conversion and OKS AP against the JAX package's chain (its Detector, its
serial harness and its ``SyntheticEvalDataset.run_eval``) on hard
benchmark scenes, with the dla_34 snapshot at 128x128 in float32 and the
tools' command lines."""

import json

import numpy as np
import pytest

from centerpose_tpu.data.synthetic import SyntheticEvalDataset as RefDataset
from centerpose_tpu.eval.harness import evaluate_detector
from centerpose_tpu.inference.detector import Detector as JaxDetector
from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools import evaluate as port_eval
from centerpose_tpu_torch.tools import hard_eval
from centerpose_tpu_torch.weights import state_dict_from_npz

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import NPZ, jax_cfg, jax_variables, torch_cfg

N = 8


@pytest.fixture(scope="module")
def runs():
    """Both chains over the first 8 scenes of the hard benchmark (seed 3)."""
    ref_ds = RefDataset(N, seed=3, hard=True)
    jd = JaxDetector(jax_cfg(128), variables=jax_variables())
    want, _, _ = evaluate_detector(jd, ref_ds.items(), workers=0)
    ds = SyntheticEvalDataset(N, seed=3, hard=True)
    td = Detector(torch_cfg(128), state_dict_from_npz(NPZ), device="cpu")
    got, times, wall = port_eval.evaluate(td, ds)
    return ref_ds, want, ds, got, times, wall


def test_per_image_detections_match_jax(runs):
    _, want, _, got, times, wall = runs
    assert sorted(got) == sorted(want) == list(range(N))
    for i in range(N):
        g, w = got[i][1], want[i][1]
        assert g.shape == w.shape == (100, 39) and g.dtype == np.float32
        # f32 model on both sides, the same uint8 input: the end-to-end
        # tolerances of tests/test_torch_detector.py
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-2)
    assert wall > 0 and set(times) == set(port_eval.STAGES)


def test_oks_ap_matches_reference_chain(runs):
    ref_ds, want, ds, got, _, _ = runs
    w = ref_ds.run_eval(want)
    g = ds.run_eval(got)
    assert set(g) == set(w)
    # detections agree to ~1e-6 in score and ~1e-4 px: no OKS crosses a
    # threshold and no two detections swap
    for k in w:
        assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])
    # the subset rule: half the images scored against their own gts only
    half = {i: got[i] for i in range(N // 2)}
    sub = ds.run_eval(half, img_ids=list(half))
    ref_sub = ref_ds.run_eval({i: want[i] for i in range(N // 2)},
                              img_ids=list(half))
    assert abs(sub["AP"] - ref_sub["AP"]) <= 1e-6
    assert ds.run_eval(half)["AP"] < sub["AP"]


def test_evaluate_cli_writes_the_reference_payload(tmp_path):
    out = tmp_path / "eval.json"
    port_eval.main(["--synthetic", "--hard", "--synthetic-size", "2",
                    "--synthetic-seed", "3", "--device", "cpu", "--json",
                    str(out), "model.input_res", "128", "model.output_res",
                    "32", "model.dcn_impl", "xla", "model.compute_dtype",
                    "float32", "test.test_scales", "[0.75,1.0]"])
    p = json.loads(out.read_text())
    assert set(p) >= {"stats", "n_images", "wall_s", "img_per_s",
                      "ms_per_img", "hard", "model_path", "device"}
    assert p["n_images"] == 2 and p["device"] == "cpu" and p["hard"]
    assert set(p["ms_per_img"]) == set(port_eval.STAGES)
    assert 0 <= p["stats"]["AP"] <= 1


def test_hard_eval_runs_a_row_and_keeps_it(tmp_path, capsys):
    out = tmp_path / "hard.json"
    args = ["--n", "1", "--rows", "xla_f32", "--device", "cpu", "--json",
            str(out)]
    hard_eval.main(args)
    p = json.loads(out.read_text())
    row = p["flagship"]["cross_impl"]["xla_f32"]
    assert row["cmd_opts"] == hard_eval.CROSS_IMPL["xla_f32"]
    assert row["n_images"] == 1 and p["eval_set"]["seed"] == 3
    assert set(hard_eval.FLAGSHIP_MODES) == {"single", "flip", "ms_flip_nms"}
    capsys.readouterr()
    hard_eval.main(args)  # a row already written is not run again
    assert "== flagship" not in capsys.readouterr().out
    with pytest.raises(SystemExit):
        hard_eval.main(["--rows", "nope", "--json", str(out)])


def test_hard_eval_backbone_row(tmp_path):
    """``--backbone NAME=NPZ``: a single-scale row on the defaults with
    ``model.name`` set, under ``backbones``; no flagship row runs unless
    ``--rows`` names it."""
    out = tmp_path / "hard.json"
    npz = "output/mbv3_hard_artifact/params_f16.npz"
    hard_eval.main(["--n", "1", "--backbone", f"mobilenetv3={npz}",
                    "--device", "cpu", "--json", str(out)])
    p = json.loads(out.read_text())
    row = p["backbones"]["mobilenetv3"]
    assert row["cmd_opts"] == hard_eval.BACKBONE_OPTS
    assert row["model_path"] == npz and row["n_images"] == 1
    assert 0 <= row["stats"]["AP"] <= 1
    assert not any(p["flagship"][plan] for plan in ("modes", "cross_impl"))
    cfg = hard_eval.backbone_config("res_18", npz)
    assert (cfg.model.name, cfg.model.head_conv, cfg.model.compute_dtype,
            cfg.model.dcn_impl, cfg.test.flip_test, tuple(cfg.test.test_scales)
            ) == ("res_18", 64, "float32", "xla", False, (1.0,))
    with pytest.raises(SystemExit):
        hard_eval.main(["--backbone", "res_18", "--json", str(out)])


def test_evaluate_config_base():
    """Without ``--cfg`` the overrides apply to the flagship, whatever
    architecture they name; with ``--defaults`` to the config defaults."""
    flag = port_eval.run_config(None, ["model.name", "hrnet_w32"])
    assert (flag.model.name, flag.model.head_conv, flag.model.compute_dtype) \
        == ("hrnet_w32", 256, "bfloat16")
    args = port_eval.parse_args(["--synthetic", "--defaults",
                                 "model.name", "hrnet_w32"])
    cfg = port_eval.run_config(args.cfg, args.opts, args.defaults)
    assert (cfg.model.name, cfg.model.head_conv, cfg.model.compute_dtype) \
        == ("hrnet_w32", 64, "float32")
