"""Loading weights that do not come from a committed snapshot, the port
against the JAX package: the upstream importer (``import_state_dict`` with
``dla34_pose_key_maps`` / ``torchvision_resnet_key_maps``) against
``import_numpy_state_dict`` on the same synthesised upstream state dicts,
bit-equal after the snapshot layout mapping; ``restore_params_filtered``
against the reference's (what keeps its init, and the lines);
``tools/check_importer``; and a training checkpoint through
``tools/evaluate.load_detector``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import centerpose_tpu.train.checkpoints as jckpt
from centerpose_tpu.models.factory import create_model as j_create
from centerpose_tpu_torch.config import update_config
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.tools import check_importer
from centerpose_tpu_torch.tools.evaluate import load_detector
from centerpose_tpu_torch.train import checkpoints as ckpt
from centerpose_tpu_torch.train.trainer import Trainer
from centerpose_tpu_torch.weights import npz_arrays, torch_key

from _torch_port import (bit_equal, jax_cfg, jax_variables, loss_targets,
                         port_state_dict, seeded, shapes, torch_cfg)


def _keystr(path: str) -> str:
    return "".join(f"['{p}']" for p in path.split("/"))


def _composed(pmap: dict, smap: dict) -> dict:
    """The reference's two maps {upstream: flax path} as one {upstream:
    port name} through ``weights.torch_key``."""
    out = {u: torch_key("params:" + _keystr(p)) for u, p in pmap.items()}
    out.update({u: torch_key("batch_stats:" + _keystr(p))
                for u, p in smap.items()})
    assert len(out) == len(pmap) + len(smap)
    return out


def _port_model(cfg, seed: int = 0):
    torch.manual_seed(seed)
    return create_model(cfg)


def _live(model) -> dict:
    return {torch_key(k): t.detach().clone()
            for k, t in ckpt.model_npz_tensors(model).items()}


def _tree(model):
    """The model's (params, batch_stats) as the reference's nested trees."""
    by_key = ckpt.model_npz_tensors(model)
    flat = npz_arrays({torch_key(k): t for k, t in by_key.items()}, by_key)
    out = {}
    for key, arr in flat.items():
        group, _, path = key.partition(":")
        node = out.setdefault(group, {})
        *parts, leaf = path[2:-2].split("']['")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out["params"], out["batch_stats"]


def _import_both(j_vars: dict, pmap: dict, smap: dict, model, sd: dict):
    """``sd`` imported into the reference tree and into the port model;
    returns (the reference's result as port tensors, the port's)."""
    imported = {
        "params": jckpt.import_numpy_state_dict(j_vars["params"], sd,
                                                key_map=pmap, verbose=False),
        "batch_stats": jckpt.import_numpy_state_dict(
            j_vars["batch_stats"], sd, key_map=smap, verbose=False)}
    ckpt.import_state_dict(model, sd, key_map=_composed(pmap, smap),
                           verbose=False)
    return port_state_dict(jax.tree_util.tree_map(np.asarray, imported)), \
        _live(model)


def test_dla34_key_maps_and_import_match_reference():
    v = jax_variables()  # the reference's dla_34 tree, head_conv 256
    pmap, smap = jckpt.dla34_pose_key_maps(v["params"], v["batch_stats"])
    model = _port_model(torch_cfg(64))
    got = ckpt.dla34_pose_key_maps(model)
    assert got == _composed(pmap, smap)
    assert sorted(got.values()) == sorted(_live(model))  # every tensor
    assert any("conv_offset_mask" in u for u in got)
    sd = check_importer.upstream_state_dict(model, got, seed=3)
    want, have = _import_both(v, pmap, smap, model, sd)
    assert sorted(have) == sorted(want)
    for name in have:
        assert bit_equal(have[name], want[name]), name


def test_torchvision_resnet_key_maps_and_import_match_reference():
    cfg = update_config(torch_cfg(64), {"model": {"name": "res_18",
                                                  "head_conv": 64}})
    jm = j_create(jax_cfg(64, name="res_18", head_conv=64))
    j_vars = seeded(shapes(jm, jnp.zeros((1, 64, 64, 3))), 1)
    j_vars = {g: j_vars[g] for g in ("params", "batch_stats")}
    pmap, smap = jckpt.torchvision_resnet_key_maps(18)
    model = _port_model(cfg)
    got = ckpt.torchvision_resnet_key_maps(18)
    assert got == _composed(pmap, smap)
    sd = check_importer.upstream_state_dict(model, got, seed=4)
    sd["fc.weight"] = np.ones((1000, 512), np.float32)  # no target
    # unmapped tensors (deconvs, heads) keep each side's own init: the
    # reference's seeded tree, the port's seeded module
    before = _live(model)
    want, have = _import_both(j_vars, pmap, smap, model, sd)
    mapped = set(got.values())
    assert 0 < len(mapped) < len(have)
    for name in have:
        if name in mapped:
            assert bit_equal(have[name], want[name]), name
        else:
            assert bit_equal(have[name], before[name]), name


def test_import_lines_and_count(capsys):
    model = _port_model(update_config(torch_cfg(64), {"model": {
        "name": "res_18", "head_conv": 64}}))
    kmap = ckpt.torchvision_resnet_key_maps(18)
    sd = check_importer.upstream_state_dict(model, kmap)
    sd["layer1.0.conv1.weight"] = np.zeros((64, 64, 5, 5), np.float32)
    ckpt.import_state_dict(model, sd, key_map=kmap)
    out = capsys.readouterr().out.splitlines()
    live = _live(model)
    n_ok = sum(1 for name in kmap.values() if name in live) - 1
    assert f"[import] loaded {n_ok}/{len(live)} params" == out[-1]
    # an array whose transpose does not fit is left as it is, and named in
    # the reference's layout and spelling, as the reference names it
    line = ("[import] shape mismatch for ['BasicBlock_0']['ConvBN_0']"
            "['Conv_0']['kernel']: (64, 64, 5, 5) vs (3, 3, 64, 64); "
            "skipping")
    assert line in out
    assert "[import] no model param for ida_up.up_1.weight; dropped" in out
    jm = j_create(jax_cfg(64, name="res_18", head_conv=64))
    params = seeded(shapes(jm, jnp.zeros((1, 64, 64, 3))), 0)["params"]
    jckpt.import_numpy_state_dict(params, sd,
                                  jckpt.torchvision_resnet_key_maps(18)[0])
    assert line in capsys.readouterr().out.splitlines()


def test_restore_params_filtered_matches_reference(capsys):
    cfg = torch_cfg(64)
    init, other = _port_model(cfg, 0), _port_model(cfg, 1)
    j_init, stats = _tree(init)
    j_loaded = _tree(other)[0]
    sd = {k: v.detach().clone() for k, v in other.named_parameters()}
    # one missing, one mis-shaped, one unexpected key, on both sides
    del sd["ida_up.node_1.DCN_0.weight"]
    del j_loaded["ida_up"]["node_1"]["DCN_0"]["kernel"]
    sd["base.base_layer.Conv_0.weight"] = torch.zeros(16, 3, 5, 5)
    j_loaded["base"]["base_layer"]["Conv_0"]["kernel"] = np.zeros(
        (5, 5, 3, 16), np.float32)
    sd["extra.Conv_0.weight"] = torch.zeros(4, 4, 1, 1)
    j_loaded["extra"] = {"Conv_0": {"kernel": np.zeros((1, 1, 4, 4),
                                                       np.float32)}}
    before = {k: v.detach().clone() for k, v in init.named_parameters()}
    capsys.readouterr()
    merged = jckpt.restore_params_filtered(j_init, j_loaded)
    want_lines = capsys.readouterr().out.splitlines()
    assert ckpt.restore_params_filtered(init, sd) is init
    got_lines = capsys.readouterr().out.splitlines()
    assert len(want_lines) == 3 and sorted(got_lines) == sorted(want_lines)
    want = port_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, merged), "batch_stats": stats})
    have = _live(init)
    for name in have:
        assert bit_equal(have[name], want[name]), name
    # the missing and mis-shaped keep their init, the rest are loaded
    keep = ("ida_up.node_1.DCN_0.weight", "base.base_layer.Conv_0.weight")
    theirs = dict(other.named_parameters())
    for name, t in init.named_parameters():
        assert torch.equal(t, before[name] if name in keep else theirs[name])
    assert not torch.equal(before[keep[0]], theirs[keep[0]])


def test_check_importer_full_coverage(tmp_path):
    v = jax_variables()
    pmap, smap = jckpt.dla34_pose_key_maps(v["params"], v["batch_stats"])
    path = tmp_path / "cov.json"
    report, cfg, model = check_importer.build_fixture_and_import(input_res=64)
    check_importer.forward_and_report(report, cfg, model,
                                      torch.device("cpu"), str(path))
    assert json.loads(path.read_text()) == {
        k: v for k, v in report.items() if k != "forward_ok"} | {
        "forward_ok": True}
    assert report["forward_ok"]
    assert report["n_mapped_params"] == report["n_params"] == len(pmap)
    assert report["n_mapped_stats"] == report["n_stats"] == len(smap)
    assert report["n_imported_params_changed"] == len(pmap)
    assert report["n_imported_stats_changed"] == len(smap)
    assert report["unmapped_params"] == report["unmapped_stats"] == []
    # what the reference's tool reports dropped
    assert report["dropped_upstream_extras"] == [
        "dla_up.ida_0.up_1.weight", "ida_up.up_1.weight",
        "ida_up.up_2.weight"]


def test_training_checkpoint_loads_in_load_detector(tmp_path, capsys):
    from centerpose_tpu.config import update_config as j_update

    # mobilenetv3 at 64x64, float32 (a small checkpoint to write and read)
    ov = {"model": {"name": "mobilenetv3", "head_conv": 64}}
    cfg = update_config(torch_cfg(64), ov)
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=1)
    b = loss_targets(cfg, batch=2, seed=2)
    b["input"] = np.random.default_rng(2).normal(
        size=(2, 64, 64, 3)).astype(np.float32)
    trainer.train_step(b)
    path = str(tmp_path / "model_best")
    ckpt.save_checkpoint(path, trainer, epoch=1, meta=ckpt.ckpt_meta(cfg),
                         async_save=False)
    det = load_detector(update_config(cfg, {"test": {"model_path": path}}),
                        "cpu")
    assert capsys.readouterr().out == ""  # the knobs match: no warning
    live = dict(trainer.model.named_parameters())
    for name, t in det.model.named_parameters():
        assert bit_equal(t.detach(), live[name].detach()), name
    bufs = dict(trainer.model.named_buffers())
    n = 0
    for name, t in det.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert bit_equal(t, bufs[name]), name
            n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                        for m in trainer.model.modules()) > 0
    assert not all(bit_equal(t, torch.zeros_like(t)) for t in bufs.values()
                   if t.is_floating_point())
    # another DCN policy than the one trained under: the reference's warning
    other = {"model": {"dcn_impl": "pallas_full"},
             "test": {"model_path": path}}
    load_detector(update_config(cfg, other), "cpu")
    got = capsys.readouterr().out
    jckpt.warn_impl_mismatch(j_update(j_update(jax_cfg(64), ov), other), path)
    want = capsys.readouterr().out
    assert got == want and "WARNING" in want
