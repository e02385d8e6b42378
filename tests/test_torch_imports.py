"""The port stands alone: no JAX, flax, optax, reference package, cv2 or
yaml on its main paths (inference, training, evaluation and the training
CLI); CUDA is never replaced quietly by the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "centerpose_tpu_torch"

_GUARD = r"""
import importlib, pkgutil, sys
for m in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "yaml"):
    sys.modules[m] = None  # any import of these now raises ImportError
import numpy as np
import centerpose_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    centerpose_tpu_torch.__path__, "centerpose_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the demo, the debugger, the importer check, the export and the bench
# tools, data parallelism, spatial sharding, the scaling bench and the
# step-ablation and input-pipeline tools import without cv2 too
assert {"centerpose_tpu_torch.utils.debugger", "centerpose_tpu_torch.tools.demo",
        "centerpose_tpu_torch.tools.check_importer",
        "centerpose_tpu_torch.tools.export",
        "centerpose_tpu_torch.tools.bench_suite",
        "centerpose_tpu_torch.tools.bench_eval",
        "centerpose_tpu_torch.parallel", "centerpose_tpu_torch.parallel.mesh",
        "centerpose_tpu_torch.parallel.spatial",
        "centerpose_tpu_torch.tools.bench_scaling",
        "centerpose_tpu_torch.tools.ablate_step",
        "centerpose_tpu_torch.tools.bench_input_pipeline"} <= set(names)
import chip_smoke  # importing must not run main()
from centerpose_tpu_torch.config import default_config, update_config
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.weights import state_dict_from_npz
cfg = update_config(default_config(), {"model": {
    "name": "dla_34", "input_res": 128, "output_res": 32, "head_conv": 256,
    "dcn_impl": "pallas_full"}})
det = Detector(cfg, state_dict_from_npz(sys.argv[1]), device="cpu")
img = np.random.default_rng(0).integers(0, 256, (120, 160, 3), np.uint8)
images, meta = det.pre_process(img)
dets = det.run_batch(images.numpy())
assert dets.shape == (1, 100, 40), dets.shape
assert np.isfinite(dets).all()
# spatial sharding's entry point on a 1 x 1 mesh (no process group): the
# one-process forward
from centerpose_tpu_torch.parallel.mesh import create_mesh_2d
meshed = Detector(cfg, state_dict_from_npz(sys.argv[1]), device="cpu",
                  mesh=create_mesh_2d(1, 1))
assert np.array_equal(meshed.run_batch(images.numpy()), dets)
# the evaluation slice: a hard benchmark scene drawn without cv2, the
# flip + multi-scale run (resize on the device, soft-NMS merge), OKS AP
from centerpose_tpu_torch.data.synthetic import SyntheticEvalDataset
ds = SyntheticEvalDataset(1, seed=3, hard=True)
ms = update_config(cfg, {"test": {"flip_test": True,
                                  "test_scales": (0.75, 1.0, 1.25)}})
ret = Detector(ms, state_dict_from_npz(sys.argv[1]), device="cpu").run(
    ds.get_raw(0)[0])
stats = ds.run_eval({0: ret["results"]})
assert 0.0 <= stats["AP"] <= 1.0 and ret["merge"] > 0, stats
# the training slice: encode (train augmentation), losses, one step
from centerpose_tpu_torch.data.encode import encode_example, stack_batch
from centerpose_tpu_torch.data.synthetic import make_person
from centerpose_tpu_torch.train.trainer import Trainer
tcfg = update_config(cfg, {"model": {"input_res": 64, "output_res": 16},
                           "train": {"wire": "compact"},
                           "dataset": {"max_objs": 4}})
rng = np.random.default_rng(0)
batch = stack_batch([encode_example(img, [make_person(rng, 160, 120)[0]],
                                    tcfg, rng) for _ in range(2)])
trainer = Trainer(tcfg, state_dict_from_npz(sys.argv[1]), device="cpu")
stats = trainer.train_step(batch)
assert np.isfinite(float(stats["loss"])) and trainer.optimizer.updates == 1
# the training CLI: the loader, checkpoints, the native core (its
# validation and AP pass run in tests/test_torch_train_cli.py)
import tempfile
sys.modules["torch.utils.tensorboard"] = None  # optional; slow to import
from centerpose_tpu_torch import native
from centerpose_tpu_torch.tools import train as train_cli
with tempfile.TemporaryDirectory() as tmp:
    run = train_cli.main([
        "--synthetic", "--synthetic-size", "2", "--device", "cpu",
        "model.input_res", "64", "model.output_res", "16",
        "train.batch_size", "2", "train.num_workers", "0", "train.epochs", "1",
        "train.val_intervals", "0", "output_dir", tmp])
assert run["trainer"].step == 1 and np.isfinite(run["first_loss"])
native.available()
# the other backbones: the factory's 14 names; a snapshot serves
from centerpose_tpu_torch.models.factory import MODEL_FACTORY
assert len(MODEL_FACTORY) == 14
bb = update_config(default_config(), {"model": {
    "name": "mobilenetv3", "input_res": 64, "output_res": 16}})
npz = sys.argv[1].replace("dla34_hard_artifact", "mbv3_hard_artifact")
bb_det = Detector(bb, state_dict_from_npz(npz), device="cpu")
dets = bb_det.run_batch(np.zeros((1, 64, 64, 3), np.uint8))
assert dets.shape == (1, 100, 40) and np.isfinite(dets).all()
# deployment: the serving function exported, saved, reloaded and run
from centerpose_tpu_torch.tools import export as export_cli
x = export_cli.example_input(bb, 1, "cpu")
with tempfile.TemporaryDirectory() as tmp:
    export_cli.save_serving(export_cli.export_serving(bb_det, x), bb_det,
                            tmp + "/mbv3.pt2")
    served = export_cli.load_serving(tmp + "/mbv3.pt2")
import torch
assert torch.equal(served(x), bb_det.process(x))
bad = [m for m in ("jax", "flax", "optax", "cv2", "yaml", "centerpose_tpu")
       if sys.modules.get(m) is not None]
assert not bad, bad
print("GUARD_OK", len(names))
"""


def test_port_imports_without_jax_cv2_yaml():
    from _torch_port import NPZ, share_cores_among_workers

    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores_among_workers()))
    proc = subprocess.run([sys.executable, "-c", _GUARD, NPZ], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GUARD_OK" in proc.stdout
    assert "[phase]" not in proc.stdout and "chip_smoke:" not in proc.stderr


def test_no_reference_imports_in_port_sources():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|flax|optax|orbax|cv2|yaml)\b"
        r"|from\s+(jax|jaxlib|flax|optax|orbax|cv2)\b"
        r"|import\s+centerpose_tpu\b(?!_)|from\s+centerpose_tpu[\s.](?!_))",
        re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        hits = pattern.findall(text)
        # yaml may be imported lazily by the config loader only, cv2 by the
        # COCO reader's image decoder, the debugger's drawing, the demo's
        # video decoding and the smoke run's optional drawing check only,
        # inside a function (indented)
        lazy_yaml = f.name == "defaults.py" and all(
            h[1] == "yaml" for h in hits)
        lazy_cv2 = (f in (PKG / "data" / "coco.py",
                          PKG / "utils" / "debugger.py",
                          PKG / "tools" / "demo.py", ROOT / "chip_smoke.py")
                    and all(h[1] == "cv2" for h in hits)
                    and not re.search(r"^(import|from)\s+cv2\b", text, re.M))
        assert not hits or lazy_yaml or lazy_cv2, (f, hits)


def test_cuda_request_without_a_card_raises(monkeypatch):
    from centerpose_tpu_torch.utils.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from centerpose_tpu_torch.inference.detector import Detector

    from _torch_port import torch_cfg

    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(torch_cfg(128))  # the default device is the card


def test_kernel_wrapper_raises_for_cuda_without_library(monkeypatch):
    from centerpose_tpu_torch.ops import dcn_cuda as dc

    from _torch_port import FakeCudaTensor

    monkeypatch.setattr(dc, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(dc.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(dc, "library_path",
                        lambda name: Path(f"/nonexistent/libcp_{name}.so"))

    def fake(*shapes):
        return [FakeCudaTensor(torch.zeros(s)) for s in shapes]

    x, w, bias, ct = fake((1, 8, 16, 8), (3, 3, 8, 4), (4,), (1, 8, 16, 4))
    omw, omb, off, mask = fake((3, 3, 8, 27), (27,), (1, 8, 16, 18),
                               (1, 8, 16, 9))
    dc.reset_launch_counts()
    # the plain version is never taken for a CUDA tensor: K1, K2 and the
    # backward each go for the library, which cannot be built here
    for call in (lambda: dc.dcn_v2_fused(x, omw, omb, w, bias, None),
                 lambda: dc.dcn_v2(x, off, mask, w, bias, 6),
                 lambda: dc.dcn_v2_backward(x, off, mask, w, ct, 6)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert all(fn.launches == 0 for fn in dc.COUNTED)
