"""The port's spans (``utils/profiling.span``): free and absent from
exported graphs when no profiler records, and nested as documented under
a ``torch.profiler`` session around serving, the training step and the
loader's prefetch, on the CPU; on the card, on the device trace's clock
and never among its device events.

The card tests need a CUDA device and nvcc; elsewhere they skip.  On the
card (JAX is not needed, so the JAX test configuration is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.data.loader import DataLoader, prefetch_to_device
from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tools import export as export_cli
from centerpose_tpu_torch.train.trainer import Trainer
from centerpose_tpu_torch.utils import profiling

SERVE = ("serve.upload", "serve.model", "serve.decode", "serve.readback")
TRAIN = ("train.upload", "train.forward", "train.backward",
         "train.optimizer")
SPANS = ("serve.batch", "train.step", "data.wait") + SERVE + TRAIN
K1, K2 = "centerpose::dcn_v2_fused", "centerpose::dcn_v2"


def _cfg(res: int = 64, **model):
    m = {"name": "res_18", "input_res": res, "output_res": res // 4}
    m.update(model)
    return update_config(default_config(), {
        "model": m, "train": {"wire": "compact"},
        "dataset": {"max_objs": 8}})


def _dla_cfg(res: int = 512):
    return _cfg(res, name="dla_34", head_conv=256, dcn_impl="pallas_full",
                compute_dtype="bfloat16")


def _frames(n: int, res: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, res, res, 3),
                                                np.uint8)


def _train_batches(cfg, n: int, size: int = 2):
    res = cfg.model.input_res
    ds = SyntheticPoseDataset(num_samples=n * size, img_w=res, img_h=res,
                              seed=1, hard=True)
    loader = DataLoader(ds, cfg, size, seed=5)
    try:
        return [b for _, b in zip(range(n), loader.epoch(0))]
    finally:
        loader.close()


def _host(prof, names=SPANS):
    """[(start, end, name)] of the host events named in ``names``, by
    start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU and e.name in names)


def _device(prof):
    """[(start, end, name)] of the device's kernels and copies (user
    annotations left out, as a reader of the device timeline takes
    them)."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def _nested(events, outer: str, inner):
    """For each ``outer`` event, the ``inner`` events inside it, checked to
    run one after another in the order given."""
    out = [e for e in events if e[2] == outer]
    for s, e, _ in out:
        kids = [k for k in events if k[2] in inner and s <= k[0]
                and k[1] <= e]
        assert [k[2] for k in kids] == list(inner), kids
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:])), kids
    return out


def test_span_without_profiler_never_records(monkeypatch):
    """No session: one shared no-op context, with no call of
    ``record_function``, for every name; the serving entry runs."""
    def fail(*args, **kw):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", fail)
    assert len({id(profiling.span(n)) for n in SPANS}) == 1
    with profiling.span("serve.batch"):
        pass
    det = Detector(_cfg(), device="cpu")
    assert det.run_batch(_frames(2, 64)).shape == (2, 100, 40)


@pytest.mark.parametrize("recording", [False, True])
def test_exported_serving_graph_holds_no_profiler_op(recording):
    """``torch.export`` of ``ServingNet``, with and without a profiler
    session recording around it: no profiler op in the graph, and the
    program computes what eager serving does."""
    det = Detector(_cfg(), device="cpu")
    x = torch.from_numpy(_frames(2, 64))
    if recording:
        with profile(activities=[ProfilerActivity.CPU]):
            program = export_cli.export_serving(det, x)
    else:
        program = export_cli.export_serving(det, x)
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function"]
    assert ops and not [o for o in ops if "profiler" in o
                        or "record_function" in o], ops
    with torch.no_grad():
        assert torch.equal(program.module()(x), det.process(x))


def test_run_batch_spans_nest_in_order():
    det = Detector(_cfg(), device="cpu")
    frames = _frames(2, 64)
    det.run_batch(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            det.run_batch(frames)
    events = _host(prof)
    assert len(_nested(events, "serve.batch", SERVE)) == 3
    assert sum(e[2] in SERVE for e in events) == 3 * len(SERVE)


def test_train_step_spans_nest_in_order():
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu")
    batches = _train_batches(cfg, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            trainer.train_step(b)
    events = _host(prof)
    assert len(_nested(events, "train.step", TRAIN)) == 2
    assert sum(e[2] in TRAIN for e in events) == 2 * len(TRAIN)


def test_prefetch_waits_once_per_batch():
    """One ``data.wait`` before each batch handed out, and one more for
    the end of the stream."""
    batches = [{"x": np.full(3, i, np.float32)} for i in range(4)]
    it = prefetch_to_device(iter(batches), "cpu", size=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [next(it) for _ in batches]
    with profile(activities=[ProfilerActivity.CPU]) as end:
        assert next(it, None) is None
    assert [float(b["x"][0]) for b in got] == [0.0, 1.0, 2.0, 3.0]
    assert len(_host(prof, ("data.wait",))) == len(batches)
    assert len(_host(end, ("data.wait",))) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see module doc)")
    return torch.device("cuda")


def _cuda_profile(step, calls: int):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            step(i)
        torch.cuda.synchronize()
    return prof


@pytest.mark.cuda
def test_serving_spans_share_the_device_clock(cuda):
    """dla_34 at 512x512 in bf16, batch 8: each batch's last
    device-to-host copy ends inside its ``serve.readback``, no span name
    is among the device's events, and the dispatcher records K1 once per
    call, 16 calls a batch."""
    det = Detector(_dla_cfg(), device="cuda")
    frames = _frames(8, 512)
    for _ in range(2):
        det.run_batch(frames)
    calls = 3
    prof = _cuda_profile(lambda i: det.run_batch(frames), calls)
    host, device = _host(prof), _device(prof)
    batches = _nested(host, "serve.batch", SERVE)
    assert len(batches) == calls
    d2h = [d for d in device if "Memcpy DtoH" in d[2]]
    for s, e, _ in batches:
        ends = [d[1] for d in d2h if s <= d[1] <= e]
        (rs, re_, _), = [h for h in host if h[2] == "serve.readback"
                         and s <= h[0] <= e]
        assert ends and rs <= max(ends) <= re_, (ends, rs, re_)
    assert not {d[2] for d in device} & set(SPANS)
    assert len(_host(prof, (K1,))) == 16 * calls


@pytest.mark.cuda
def test_training_spans_stay_off_the_device(cuda):
    """dla_34 at 512x512 in bf16, batch 2: the step's spans nest in order,
    none is among the device's events, and the dispatcher records K2 once
    per call, 16 calls a step."""
    cfg = _dla_cfg()
    trainer = Trainer(cfg, device="cuda")
    batches = _train_batches(cfg, 2)
    trainer.train_step(batches[0])
    steps = 2
    prof = _cuda_profile(lambda i: trainer.train_step(batches[i % 2]), steps)
    host, device = _host(prof), _device(prof)
    assert len(_nested(host, "train.step", TRAIN)) == steps
    assert not {d[2] for d in device} & set(SPANS)
    assert len(_host(prof, (K2,))) == 16 * steps
