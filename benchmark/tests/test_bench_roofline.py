"""The frozen roofline arithmetic against values worked out by hand, and
the trace reductions the per-layer metrics read."""

import pytest

from benchmark.harness import roofline
from benchmark.harness.trace import Trace, busy_us


def test_k1_bound_by_hand():
    # batch 8, 128x128, 64 -> 64 in bf16: P = 131072 pixels
    # bytes 2 * (P*64 + 9*64*64 + 64 + 9*64*27 + 27 + P*64)
    #     = 2 * (8388608 + 36864 + 64 + 15552 + 27 + 8388608) = 33659446
    # flops 2 * P * 9 * 64 * (64 + 27) = 13740539904
    ms, by = roofline.k1_bound(8, 128, 64, 64, "bfloat16")
    t_bytes = 33659446 / 3.35e12
    t_ops = 13740539904 / 989e12
    assert by == "operations"
    assert ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0138934, rel=1e-5)


def test_train_bounds_by_hand():
    # batch 32, 16x16, 512 -> 256 in bf16: P = 8192, product
    # 2 * P * 9 * 512 * 256 = 19327352832 operations
    (fwd, fby), (bwd, bby) = roofline.train_bounds(32, 16, 512, 256,
                                                   "bfloat16")
    fwd_bytes = 2 * (8192 * (512 + 27 + 256) + 9 * 512 * 256) + 4 * 256
    bwd_bytes = 2 * (2 * 8192 * (512 + 27) + 2 * 9 * 512 * 256
                     + 8192 * 256) + 4 * 256
    assert fwd == pytest.approx(max(fwd_bytes / 3.35e12,
                                    19327352832 / 989e12) * 1e3)
    assert bwd == pytest.approx(max(bwd_bytes / 3.35e12,
                                    2 * 19327352832 / 989e12) * 1e3)
    assert (fby, bby) == ("operations", "operations")


def test_busy_union():
    spans = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (21, 22, "d")]
    assert busy_us(spans) == 25


def test_idle_gaps_labelled_by_innermost_host_op():
    t = Trace(device=[(10, 20, "k"), (40, 50, "k")],
              host=[(0, 100, "outer"), (25, 35, "inner")],
              start_us=0, end_us=60)
    gaps = dict(t.idle_gaps())
    assert gaps == {"outer": pytest.approx(20e-6),
                    "inner": pytest.approx(20e-6)}
    assert dict(t.top_ops()) == {"k": pytest.approx(20e-6)}
