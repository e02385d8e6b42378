"""The readers of the program's spans (``harness/spans.py`` and the
``metrics/`` that use it) on hand-built traces whose answers are worked
out by hand, and on small traced runs of the harness on the CPU."""

import pytest

from benchmark import run
from benchmark.harness import spans
from benchmark.harness.manifest import Manifest
from benchmark.harness.trace import Trace
from benchmark.tests import small

SERVE_READERS = ("upload_ms.serve", "dispatch_ms.serve",
                 "dispatch_idle_frac.serve", "outside_idle_frac.serve",
                 "k1_host_us.serve")
TRAIN_READERS = ("upload_ms.train", "dispatch_idle_frac.train",
                 "k2_host_us.train")
SERVE_INFO = {"kind": "serve"}
TRAIN_INFO = {"kind": "train"}


def read(name, trace, info):
    return Manifest().reader(name).read(trace, info)


def serve_trace(with_spans: bool = True) -> Trace:
    """Two batches in a stretch of 100 us.  Each: ``serve.batch`` holding
    the upload (5 us), the model (20), the decode (10) and the read-back
    (10); K1 called three times.  Device busy 59 us, idle 41:
    (0,2) (8,10) (20,28) (32,40) (44,52) (58,60) (80,88) (94,96) (99,100)."""
    device = [(2, 8, "Memcpy HtoD"), (10, 20, "k"), (28, 32, "k"),
              (40, 44, "Memcpy DtoH"), (52, 58, "Memcpy HtoD"),
              (60, 80, "k"), (88, 94, "Memcpy DtoH"), (96, 99, "k")]
    host = [(1, 3, "aten::copy_"), (6, 9, "centerpose::dcn_v2_fused"),
            (12, 17, "centerpose::dcn_v2_fused"),
            (56, 59, "centerpose::dcn_v2_fused")]
    if with_spans:
        for b in (0, 50):
            host += [(b, b + 45, "serve.batch"),
                     (b, b + 5, "serve.upload"),
                     (b + 5, b + 25, "serve.model"),
                     (b + 25, b + 35, "serve.decode"),
                     (b + 35, b + 45, "serve.readback")]
    else:
        host = host[:1]
    return Trace(device=device, host=host, items=2, start_us=0, end_us=100)


def train_trace(with_spans: bool = True) -> Trace:
    """One step in a stretch of 100 us: the upload (10 us), the forward
    (30), the backward (40), the optimizer (15); K2 called twice.  Device
    idle (0,5) (15,20) (60,70) (90,100): 30 us."""
    device = [(5, 15, "k"), (20, 60, "k"), (70, 90, "k")]
    host = [(11, 13, "aten::mm")]
    if with_spans:
        host += [(0, 100, "train.step"), (0, 10, "train.upload"),
                 (10, 40, "train.forward"), (40, 80, "train.backward"),
                 (80, 95, "train.optimizer"),
                 (12, 14, "centerpose::dcn_v2"),
                 (16, 22, "centerpose::dcn_v2")]
    return Trace(device=device, host=host, items=1, start_us=0, end_us=100)


def test_interval_arithmetic():
    t = Trace(device=[(-5, 3, "k"), (2, 4, "k"), (8, 9, "k"),
                      (15, 30, "k")],
              host=[(-3, 1, "a"), (0, 5, "a"), (7, 12, "b"), (11, 20, "a")],
              start_us=0, end_us=20)
    assert spans.merge([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]
    assert spans.idle(t) == [(4, 8), (9, 15)]
    assert spans.union(t, ("a",)) == [(0, 5), (11, 20)]
    assert spans.durations(t, "a") == [1, 5, 9]
    # (4,5) (7,8) (9,15)
    assert spans.overlap_us(spans.idle(t), spans.union(t, ("a", "b"))) == 8
    # the idle time is the stretch less the device's busy union
    assert spans.length_us(spans.idle(t)) == pytest.approx(
        20 - 1e6 * Trace(device=[(0, 4, ""), (8, 9, ""), (15, 20, "")],
                         start_us=0, end_us=20).busy_s)


def test_serve_readers_by_hand():
    t = serve_trace()
    assert read("upload_ms.serve", t, SERVE_INFO) == pytest.approx(0.005)
    assert read("dispatch_ms.serve", t, SERVE_INFO) == pytest.approx(0.03)
    # idle inside the model and decode: (8,10) (20,28) (32,35) (58,60)
    # (80,85)
    assert read("dispatch_idle_frac.serve", t, SERVE_INFO) == \
        pytest.approx(20.0)
    # idle outside both batches: (45,50) (95,96) (99,100)
    assert read("outside_idle_frac.serve", t, SERVE_INFO) == \
        pytest.approx(7.0)
    assert read("k1_host_us.serve", t, SERVE_INFO) == pytest.approx(11 / 3)


def test_serve_idle_splits_into_its_readers():
    """``idle_frac.serve`` = the idle time in the serving step + outside
    every batch + in the upload and the read-back (the remainder)."""
    t = serve_trace()
    total = read("idle_frac.serve", t, SERVE_INFO)
    idle = spans.idle(t)
    rest = 100 * spans.overlap_us(idle, spans.union(
        t, ("serve.upload", "serve.readback"))) / spans.stretch_us(t)
    assert total == pytest.approx(41.0)
    assert rest == pytest.approx(14.0)
    assert total == pytest.approx(
        read("dispatch_idle_frac.serve", t, SERVE_INFO)
        + read("outside_idle_frac.serve", t, SERVE_INFO) + rest)


def test_train_readers_by_hand():
    t = train_trace()
    assert read("upload_ms.train", t, TRAIN_INFO) == pytest.approx(0.01)
    # idle inside forward, backward and optimizer: (15,20) (60,70) (90,95)
    assert read("dispatch_idle_frac.train", t, TRAIN_INFO) == \
        pytest.approx(20.0)
    assert read("idle_frac.train", t, TRAIN_INFO) == pytest.approx(30.0)
    assert read("k2_host_us.train", t, TRAIN_INFO) == pytest.approx(4.0)


@pytest.mark.parametrize("name", SERVE_READERS + TRAIN_READERS)
def test_readers_without_spans_or_of_the_other_kind_read_none(name):
    serve = name.endswith(".serve")
    info, other = ((SERVE_INFO, TRAIN_INFO) if serve
                   else (TRAIN_INFO, SERVE_INFO))
    bare = serve_trace(False) if serve else train_trace(False)
    assert read(name, bare, info) is None
    full = serve_trace() if serve else train_trace()
    assert read(name, full, info) is not None
    assert read(name, full, other) is None


def test_manifest_lists_every_reader():
    m = Manifest()
    for name in SERVE_READERS + TRAIN_READERS:
        entry = m.per_layer[name]
        assert entry["source"] == "device_trace"
        assert entry["moves"] == ("serve_img_s" if name.endswith(".serve")
                                  else "train_img_s")


@pytest.mark.parametrize("cell", ["dla34-stream-b8", "hrnet32-stream-b8"])
def test_small_stream_run_reads_every_span_reader(cell):
    line = run.execute(small.context(cell, trace=True), Manifest())
    want = {n for n in SERVE_READERS if cell in
            Manifest().per_layer[n]["workloads"]}
    assert want <= set(line["metrics"]), line["metrics"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["dispatch_idle_frac.serve"] + m["outside_idle_frac.serve"] \
        <= m["idle_frac.serve"] + 1e-9


def test_small_training_run_reads_the_span_readers():
    """Every training reader but K2's, whose operator the CPU's training
    path does not call."""
    line = run.execute(small.train_context(trace=True), Manifest())
    assert {"upload_ms.train", "dispatch_idle_frac.train"} <= \
        set(line["metrics"]), line["metrics"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["dispatch_idle_frac.train"] <= m["idle_frac.train"] + 1e-9
