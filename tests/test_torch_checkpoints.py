"""The port's checkpoints (``train/checkpoints.py``): save -> load ->
``restore_state`` bit-equal, a mismatched optimizer refused, the
reference's ``warn_impl_mismatch`` messages, and npz snapshots that the
reference's ``load_params_npz`` reads back to the same heads."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import centerpose_tpu.train.checkpoints as jckpt
from centerpose_tpu.models.factory import create_model as j_create
from centerpose_tpu_torch.config import update_config
from centerpose_tpu_torch.data.encode import encode_example, stack_batch
from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset
from centerpose_tpu_torch.train import checkpoints as ckpt
from centerpose_tpu_torch.train.trainer import Trainer

from _torch_port import bit_equal, jax_cfg, jax_variables, rel_err, torch_cfg

HEADS = ("hm", "wh", "hps", "reg", "hm_hp", "hp_offset")


def _cfg(**train):
    return update_config(torch_cfg(64, "pallas_full"),
                         {"train": {"lr_step": (1,), **train}})


def _batch(seed=0, n=2):
    cfg = _cfg()
    ds = SyntheticPoseDataset(n, img_w=160, img_h=120, seed=seed, hard=True)
    return stack_batch([encode_example(*ds.get_raw(i), cfg,
                                       np.random.default_rng((seed, i)))
                        for i in range(n)])


def _host(trainer):
    return ckpt.to_host(trainer.state())


@pytest.fixture(scope="module")
def trained():
    """A trainer two updates in (past the schedule's decay at update 1)."""
    trainer = Trainer(_cfg(), device="cpu", steps_per_epoch=1)
    batch = _batch()
    for _ in range(2):
        trainer.train_step(batch)
    return trainer, batch


def test_save_load_restore_bit_equal(trained, tmp_path):
    trainer, batch = trained
    path = str(tmp_path / "model_last")
    ckpt.save_checkpoint(path, trainer, epoch=2, meta=ckpt.ckpt_meta(_cfg()))
    ckpt.wait_for_saves()
    assert os.path.exists(path + ".meta.json")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    payload = ckpt.load_checkpoint(path)
    assert payload["epoch"] == 2 and payload["step"] == 2
    fresh = Trainer(_cfg(), device="cpu", steps_per_epoch=1)
    assert not bit_equal(_host(fresh)["model"], _host(trainer)["model"])
    ckpt.restore_state(fresh, payload)
    assert bit_equal(_host(fresh), _host(trainer))
    assert fresh.optimizer.updates == 2
    assert [g["lr"] for g in fresh.optimizer.opt.param_groups] == [1.25e-5]
    # the next step of each gives the same loss and the same parameters
    a = trainer.train_step(batch)
    b = fresh.train_step(batch)
    assert float(a["loss"]) == float(b["loss"])
    assert bit_equal(_host(fresh), _host(trainer))


def test_resaving_drops_the_stale_sidecar(trained, tmp_path):
    trainer, _ = trained
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, trainer, meta={"dcn_impl": "xla"})
    ckpt.save_checkpoint(path, trainer, async_save=False)
    assert not os.path.exists(path + ".meta.json")


def test_restore_refuses_another_optimizer(trained, tmp_path):
    trainer, batch = trained
    path = str(tmp_path / "adam")
    ckpt.save_checkpoint(path, trainer, async_save=False)
    payload = ckpt.load_checkpoint(path)
    sgd = Trainer(_cfg(optimizer="sgd"), device="cpu", steps_per_epoch=1)
    with pytest.raises(ValueError, match="opt_state mismatch"):
        ckpt.restore_state(sgd, payload)
    sgd.train_step(batch)  # an SGD state the other way round
    ckpt.save_checkpoint(path, sgd, async_save=False)
    with pytest.raises(ValueError, match="opt_state mismatch"):
        ckpt.restore_state(Trainer(_cfg(), device="cpu"),
                           ckpt.load_checkpoint(path))
    bad = dict(payload, model=dict(payload["model"]))
    name = next(iter(bad["model"]))
    bad["model"][name] = bad["model"][name][..., :1]
    with pytest.raises(ValueError, match="model mismatch"):
        ckpt.restore_state(Trainer(_cfg(), device="cpu"), bad)


def test_ckpt_meta_matches_reference():
    for impl in ("xla", "pallas_full"):
        assert ckpt.ckpt_meta(torch_cfg(512, impl)) == jckpt.ckpt_meta(
            jax_cfg(512, impl))


# (trained under, evaluated under, edit of the sidecar): the reference's
# cases of a semantic mismatch, a forward-family match, a note only, the
# auto-clamp table and a missing sidecar
_CASES = [
    (dict(dcn_impl="xla"), dict(dcn_impl="pallas_full"), None),
    (dict(dcn_impl="pallas"), dict(dcn_impl="pallas_full"), None),
    (dict(dcn_impl="pallas_full"), dict(dcn_impl="xla"), None),
    (dict(dcn_impl="pallas_full", dcn_max_dy=4),
     dict(dcn_impl="pallas_full"), None),
    (dict(dcn_impl="pallas_full", compute_dtype="bfloat16"),
     dict(dcn_impl="pallas_full"), None),
    (dict(dcn_impl="pallas_full"), dict(dcn_impl="pallas_full"),
     {"dcn_default_max_dy": {"16": 4, "32": 4, "64": 4, "128": 4}}),
    (dict(dcn_impl="pallas_full"), dict(dcn_impl="pallas_full"), "drop"),
    (dict(dcn_impl="xla"), dict(dcn_impl="xla"), "drop"),
]


@pytest.mark.parametrize("trained_under,eval_under,edit", _CASES)
def test_warn_impl_mismatch_matches_reference(tmp_path, capsys,
                                              trained_under, eval_under, edit):
    path = str(tmp_path / "model_best")
    meta = ckpt.ckpt_meta(torch_cfg(512, **trained_under))
    if edit == "drop":
        meta = None
    elif edit:
        meta.update(edit)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    got = ckpt.warn_impl_mismatch(torch_cfg(512, **eval_under), path)
    got_out = capsys.readouterr().out
    want = jckpt.warn_impl_mismatch(jax_cfg(512, **eval_under), path)
    want_out = capsys.readouterr().out
    assert got == want and got_out == want_out


def test_npz_snapshot_reads_back_in_the_reference(tmp_path):
    """A randomly initialised port model -> ``save_params_npz`` -> the
    reference's ``load_params_npz`` -> the reference's f32 heads equal the
    port's; and the snapshot loads back into the port unchanged."""
    trainer = Trainer(torch_cfg(64), device="cpu")
    model = trainer.model.eval()
    path = str(tmp_path / "params.npz")
    ckpt.save_params_npz(model, path)
    variables = jckpt.load_params_npz(jax_variables(), path)
    x = np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jmodel = j_create(jax_cfg(64))
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for name in HEADS:
        assert rel_err(got[name].numpy(), np.asarray(want[name])) < 1e-4, name
    again = ckpt.load_params_npz(Trainer(torch_cfg(64), device="cpu").model,
                                 path)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n
    ckpt.save_params_npz(model, str(tmp_path / "f16.npz"), dtype=np.float16)
    with np.load(str(tmp_path / "f16.npz")) as data:
        assert {data[k].dtype for k in data.files if k.startswith("params:")} \
            == {np.dtype(np.float16)}
