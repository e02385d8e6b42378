"""The controls: the reference put in the program's place one precision
step below the configuration's has to come out not correct.  On the CPU
at a small size (bfloat16 against float8; TF32 has no CPU path), and on
the card at the cells' own sizes (``cuda``)."""

import pytest
import torch

from benchmark import calibrate
from benchmark.harness.manifest import ROOT, Manifest
from benchmark.run import Context
from benchmark.tests import faults, small


def test_fp8_control_stands_apart_on_cpu():
    """At 128x128 the float8 control's gaps are several times the bf16
    program's."""
    r = calibrate.calibrate(small.context("dla34-stream-b8"), [1], [2])
    low, up = r["lower"], r["upper_control"]
    assert max(up[k] / max(low[k], 1e-12) for k in ("score", "box",
                                                     "joint")) >= 3.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dla34-stream-b8", "hrnet32-stream-b8",
                                  "dla34-train-b32"])
def test_control_fails_at_cell_size(cell):
    """Three seeds at the cell's own size: the program passes the cell's
    limits, and the control and every planted fault fail them (the decode
    faults of ``faults.py`` in a serving cell; in the training cell a step
    that leaves half the batch out and a DCN weight gradient over half of
    it)."""
    _card()
    m = Manifest()
    c = m.cell(cell)
    ctx = Context(ROOT, c, m.config(c), m.traffic(c), m.limits(c), 0, 0.0,
                  False)
    seeds = [2100000001, 2100000002, 2100000003]
    if ctx.traffic["kind"] == "train":
        r = calibrate.calibrate_train(ctx, seeds, seeds)
        sides = ("control", "half_batch", "dcn_weight_grad_half")
    else:
        r = calibrate.calibrate(ctx, seeds, seeds)
        sides = ("control", *faults.DECODE)
    limits = ctx.limits
    for g in r["program"].values():
        assert not _fails(g, limits), g
    for side in sides:
        assert len(r[side]) == len(seeds), side
        for g in r[side].values():
            assert _fails(g, limits), (side, g)
