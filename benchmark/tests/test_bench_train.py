"""The training cell's run at a small size on the CPU: a sound step is
correct, and a step with a fault planted in it is not."""

import pytest

from benchmark import run
from benchmark.harness.manifest import Manifest
from benchmark.tests import faults, small


def drive(**kw):
    ctx = small.train_context(**kw)
    # float32 on the CPU: the faults, not bf16 rounding, are under test
    ctx.overrides["model"]["compute_dtype"] = "float32"
    return run.execute(ctx, Manifest())


def test_sound_step_is_correct():
    line = drive(trace=True)
    assert line["correct"], line["checks"]
    m = Manifest()
    limits = m.limits(m.cell("dla34-train-b32"))
    assert set(line["checks"]) == {f"{k}_gap" for k in limits}
    assert line["breakdown"]["device_ops"]


def _unchanged(orig):
    """A step that computes its gradients and leaves the state as it was."""
    def broken(self, batch):
        stats = self.backward(batch)
        self.model.zero_grad(set_to_none=True)
        self.step += 1
        return stats
    return broken


def _half_batch(orig):
    def broken(self, batch):
        return orig(self, {k: v[: len(v) // 2] for k, v in batch.items()})
    return broken


def _altered_loss(orig):
    """A step whose reported loss is altered where it is produced."""
    def broken(self, batch):
        stats = orig(self, batch)
        return dict(stats, loss=stats["loss"] * 1.01)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_broken_step_is_not_correct(monkeypatch, fault):
    from centerpose_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "train_step", fault(Trainer.train_step))
    line = drive()
    assert not line["correct"], line["checks"]


def test_dcn_weight_grad_fault_is_not_correct():
    """The DCN backward's weight and bias gradients summed over half the
    batch: the first loss and the median leaf stay as they are, the DCN
    sites' leaves do not."""
    with faults.dcn_through_operator(), \
            faults.dcn_weight_grad_half() as broken:
        line = drive()
    assert broken.calls > 0
    assert not line["correct"], line["checks"]
