"""The port's visualisation (``utils/debugger.py``) against the JAX
package's: ``Debugger`` drawings byte-equal on seeded rows and images,
``render_train_debug`` on one seeded batch of the port's encoder (dla_34
at 64x64, float32, the snapshot) with its ground-truth renders byte-equal
and its predicted ones within one heatmap level at no more than 1% of the
pixels, and the training CLI's ``debug 1`` renders."""

import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax
import numpy as np

from centerpose_tpu.utils import debugger as ref
from centerpose_tpu_torch.data.encode import encode_example, stack_batch
from centerpose_tpu_torch.data.synthetic import render_scene
from centerpose_tpu_torch.tools import train as train_cli
from centerpose_tpu_torch.utils import debugger as port

from _torch_port import jax_cfg, jax_variables, torch_cfg, torch_model

RENDERS = ("pred_hm", "gt_hm", "pred_hm_hp", "gt_hm_hp")


def _rows(seed: int, n: int = 12) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = np.zeros((n, 39), np.float32)
    xy = rng.uniform(-20, 300, (n, 2))
    d[:, 0:2] = xy
    d[:, 2:4] = xy + rng.uniform(10, 150, (n, 2))
    d[:, 4] = rng.uniform(0, 1, n)
    d[:, 5:] = rng.uniform(-30, 330, (n, 34))  # some joints off the image
    return d


def test_debugger_drawings_byte_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    hm = rng.uniform(0, 1, (60, 80, 17)).astype(np.float32)
    hm1 = rng.uniform(-0.2, 1.2, (60, 80)).astype(np.float32)
    for seed in range(3):
        dbg_r, dbg_p = ref.Debugger(), port.Debugger()
        for dbg in (dbg_r, dbg_p):
            dbg.add_img(img, "f")
            dbg.add_multi_pose(_rows(seed), 0.3, "f")
            dbg.add_blend_heatmap(img, hm, "hm")
            dbg.add_blend_heatmap(img, hm1, "hm1")
        assert list(dbg_p.imgs) == list(dbg_r.imgs) == ["f", "hm", "hm1"]
        for k in dbg_r.imgs:
            np.testing.assert_array_equal(dbg_p.imgs[k], dbg_r.imgs[k])
        assert not np.array_equal(dbg_p.imgs["f"], img)  # something drawn
    np.testing.assert_array_equal(np.asarray(port._EDGE_COLORS),
                                  np.asarray(ref._EDGE_COLORS))


def _batch(cfg, n: int = 2):
    rng = np.random.default_rng(5)
    examples = []
    for i in range(n):
        img, anns = render_scene(np.random.default_rng(100 + i), 160, 120, 2)
        examples.append(encode_example(img, anns, cfg, rng, is_train=False))
    return stack_batch(examples)


def _read(d: Path, i: int, name: str) -> np.ndarray:
    img = cv2.imread(str(d / f"img{i}_{name}.png"))
    assert img is not None, (i, name)
    return img


def test_render_train_debug_matches_reference(tmp_path, monkeypatch):
    from centerpose_tpu.config import update_config as j_update
    from centerpose_tpu.models.factory import create_model as j_create
    from centerpose_tpu_torch.config import update_config

    ov = {"dataset": {"max_objs": 8}}
    tcfg = update_config(torch_cfg(64), ov)
    jcfg = j_update(jax_cfg(64), ov)
    batch = _batch(tcfg)
    levels = {"port": [], "ref": []}
    real = cv2.applyColorMap

    def spy(h, cmap):  # the uint8 heatmap levels of each render, in order
        levels[side].append(h.copy())
        return real(h, cmap)

    monkeypatch.setattr(cv2, "applyColorMap", spy)
    side = "port"
    model = torch_model(tcfg).train()
    port.render_train_debug(model, batch, tcfg, str(tmp_path / "port"))
    assert model.training  # the mode is restored
    side = "ref"
    # the reference's model with its apply jitted: the same function in a
    # sixth of eager flax's time
    jmodel = SimpleNamespace(apply=jax.jit(j_create(jcfg).apply,
                                           static_argnames="train"))
    ref.render_train_debug(jmodel, jax_variables(), batch, jcfg,
                           str(tmp_path / "ref"))
    assert len(levels["port"]) == len(levels["ref"]) == 2 * len(RENDERS)
    for k, (got, want) in enumerate(zip(levels["port"], levels["ref"])):
        i, name = divmod(k, len(RENDERS))
        name = RENDERS[name]
        png_p, png_r = (_read(tmp_path / s, i, name) for s in ("port", "ref"))
        assert png_p.shape == png_r.shape == (64, 64, 3)
        if name.startswith("gt"):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(png_p, png_r)
            continue
        # the f32 heads agree to ~1e-6 relative: a level may round the
        # other way where a value sits at a level's edge
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01, (
            i, name, diff.max(), np.mean(diff > 0))
        assert got.max() > 0
    assert not (tmp_path / "port" / "img2_gt_hm.png").exists()


def test_train_cli_debug_renders(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # res_18 at the defaults (float32) on the compact wire, whose uint8
    # input the renders decode as the step does
    run = train_cli.main([
        "--synthetic", "--synthetic-size", "2", "--device", "cpu",
        "--defaults", "model.input_res", "64", "model.output_res", "16",
        "train.wire", "compact", "train.batch_size", "2",
        "train.num_workers", "0", "train.epochs", "1",
        "train.val_intervals", "1", "train.val_ap_limit", "1",
        "dataset.max_objs", "8", "debug", "1",
        "output_dir", str(tmp_path), "exp_id", "d"])
    d = Path(run["log_dir"]) / "debug" / "epoch_1"
    for i in range(2):
        for name in RENDERS:
            img = _read(d, i, name)
            assert img.shape == (64, 64, 3) and img.std() > 0
