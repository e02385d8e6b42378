"""The frozen reference against the port on the CPU at a small size, with
the same snapshot weights and frames: a wrong reference fails here
first.  And the reference loads nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.drivers import stream
from benchmark.harness import program, scenes
from benchmark.harness.manifest import ROOT
from benchmark.reference import judge, nets
from benchmark.tests import small


@pytest.fixture(scope="module", params=["dla34-stream-b8",
                                        "hrnet32-stream-b8"])
def pair(request):
    """(ctx, the port's float32 detector, two frames) of a small cell."""
    ctx = small.context(request.param)
    over = {"model": dict(ctx.overrides["model"],
                          compute_dtype="float32")}
    det = program.detector(ctx.root, ctx.cfg, "cpu", **over)
    frames = np.stack([scenes.render_scene_hard(
        np.random.default_rng([7, i]), 128, 128, 6)[0] for i in range(2)])
    return ctx, det, frames


def test_heads_match_port(pair):
    ctx, det, frames = pair
    cfg = ctx.cfg
    x = torch.from_numpy(frames).float() / 255.0
    x = (x - torch.tensor(cfg["mean"])) / torch.tensor(cfg["std"])
    p = nets.Params(program.snapshot(ROOT, cfg), "cpu")
    with torch.no_grad():
        ref = nets.forward(cfg["arch"], nets.Numerics(), p, x, judge.HEADS,
                           cfg["dcn_r"])
        out = det.model(x)
    for name, r in ref.items():
        err = float((out[name] - r).abs().max() / r.abs().max())
        assert err < 1e-4, (name, err)


def test_served_rows_judged_sound(pair):
    """The float32 port's served rows are within rounding of the
    reference by every gap."""
    ctx, det, frames = pair
    maps = stream.reference_maps(ROOT, ctx.cfg, torch.device("cpu"),
                                 {0: frames})
    g = judge.gaps(torch.from_numpy(det.run_batch(frames)), maps[0],
                   ctx.limits)
    assert max(g.values()) < 1e-3, g


def test_decode_matches_port():
    from centerpose_tpu_torch.ops.decode import multi_pose_decode

    g = torch.Generator().manual_seed(0)
    n, h, w = 2, 24, 24
    maps = {"hm": torch.rand(n, h, w, 1, generator=g),
            "wh": torch.rand(n, h, w, 2, generator=g) * 10,
            "hps": torch.randn(n, h, w, 34, generator=g) * 3,
            "reg": torch.rand(n, h, w, 2, generator=g),
            "hm_hp": torch.rand(n, h, w, 17, generator=g),
            "hp_offset": torch.rand(n, h, w, 2, generator=g)}
    rows = judge.decode(maps, 20)
    port = multi_pose_decode(maps["hm"], maps["wh"], maps["hps"],
                             maps["reg"], maps["hm_hp"], maps["hp_offset"],
                             k=20)
    assert torch.equal(rows, port)
    exact = {"score": 0.0, "box": 0.0, "joint": 0.0}
    assert max(judge.gaps(port, maps, exact).values()) < 1e-5


def test_scenes_match_port():
    from centerpose_tpu_torch.data import synthetic

    for seed in (0, 3):
        a = scenes.render_scene_hard(np.random.default_rng(seed), 512, 512)
        b = synthetic.render_scene_hard(np.random.default_rng(seed), 512,
                                        512)
        assert np.array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.nets, "
            "benchmark.reference.judge, benchmark.harness.scenes, "
            "benchmark.harness.roofline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('centerpose_tpu_torch', 'centerpose_tpu', 'jax', 'jaxlib', "
            "'flax')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def _ridge_maps(valley: bool):
    """One 16x16 frame: a ridge of centre heat along row 5 from column 3
    (the reference's maximum, 0.502) down to column 9 (0.5), optionally
    cut by a valley at column 6; background 1e-4, no keypoint peak."""
    h = w = 16
    hm = torch.full((1, h, w, 1), 1e-4)
    for c in range(3, 10):
        hm[0, 5, c, 0] = 0.502 - (c - 3) * 0.002 / 6
    if valley:
        hm[0, 5, 6, 0] = 0.3
    maps = {"hm": hm, "wh": torch.full((1, h, w, 2), 4.0),
            "hps": torch.zeros(1, h, w, 34),
            "reg": torch.full((1, h, w, 2), 0.5),
            "hm_hp": torch.full((1, h, w, 17), 1e-4),
            "hp_offset": torch.zeros(1, h, w, 2)}
    return maps


def _row(y, x, score):
    """A served row at cell (y, x) of ``_ridge_maps``."""
    cx, cy = x + 0.5, y + 0.5
    joints = [v for _ in range(17) for v in (x, y)]
    return [cx - 2, cy - 2, cx + 2, cy + 2, score, *joints, 0.0]


@pytest.mark.parametrize("valley", [False, True])
def test_missed_follows_the_ridge(valley):
    """A row served at the far end of a ridge that stays within the tie of
    the reference's maximum serves that maximum; across a valley it does
    not."""
    maps = _ridge_maps(valley)
    rows = torch.tensor([[_row(5, 9, float(maps["hm"][0, 5, 9, 0])),
                          _row(12, 12, 1e-4)]])
    g = judge.gaps(rows, maps, {"score": 0.025, "box": 0.09, "joint": 0.2})
    assert g["peak"] < 1e-3 and g["order"] == 0.0
    assert (g["missed"] > 0.4) == valley, g
