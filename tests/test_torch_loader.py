"""The port's input pipeline (``data/loader.py``): batches that do not
depend on the number of encode workers and equal the reference
``DataLoader``'s for the same seeds, sharding, and the device prefetch."""

import numpy as np
import pytest
import torch

from centerpose_tpu.data.loader import DataLoader as JDataLoader
from centerpose_tpu.data.synthetic import SyntheticPoseDataset as JDataset
from centerpose_tpu_torch.data.loader import DataLoader, prefetch_to_device
from centerpose_tpu_torch.data.synthetic import SyntheticPoseDataset

from _torch_port import jax_cfg, torch_cfg

WIRE = {"train": {"wire": "compact"}, "dataset": {"max_objs": 8}}
DS = dict(num_samples=6, img_w=160, img_h=120, seed=1, hard=True)


def _cfgs():
    from centerpose_tpu.config import update_config as jupdate
    from centerpose_tpu_torch.config import update_config

    return update_config(torch_cfg(64), WIRE), jupdate(jax_cfg(64), WIRE)


def _batches(loader, epoch, n=3):
    try:
        return [b for _, b in zip(range(n), loader.epoch(epoch))]
    finally:
        loader.close()


def test_batches_do_not_depend_on_workers_and_match_reference():
    cfg, jcfg = _cfgs()
    ds = SyntheticPoseDataset(**DS)
    serial = _batches(DataLoader(ds, cfg, 2, seed=5), epoch=3)
    pooled = _batches(DataLoader(ds, cfg, 2, seed=5, num_workers=2), epoch=3)
    ref = _batches(JDataLoader(JDataset(**DS), jcfg, 2, seed=5), epoch=3)
    assert len(serial) == len(pooled) == len(ref) == 3
    for a, b, r in zip(serial, pooled, ref):
        assert a.keys() == b.keys() == r.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
            if k == "input":
                # cv2's fixed-point warp against the port's float32 one
                # (tests/test_torch_train_data.py): one uint8 level at most
                d = np.abs(a[k].astype(int) - r[k].astype(int))
                assert d.max() <= 1
            else:
                assert a[k].dtype == r[k].dtype, k
                assert np.array_equal(a[k], r[k]), k


def test_shards_split_the_epoch_and_steps_per_epoch():
    cfg, _ = _cfgs()
    ds = SyntheticPoseDataset(**{**DS, "num_samples": 8})
    loaders = [DataLoader(ds, cfg, 2, seed=3, shard_id=i, num_shards=2)
               for i in range(2)]
    assert [ld.steps_per_epoch() for ld in loaders] == [2, 2]
    assert DataLoader(ds, cfg, 3, drop_last=False).steps_per_epoch() == 3
    seen = [b["input"] for ld in loaders for b in _batches(ld, 0, 2)]
    whole = [b["input"] for b in _batches(DataLoader(ds, cfg, 2, seed=3), 0, 4)]
    # the two shards' examples are the whole epoch's, each once
    key = lambda bs: sorted(im.tobytes() for b in bs for im in b)
    assert key(seen) == key(whole) and len(set(key(whole))) == 8


def test_prefetch_yields_the_batches_as_tensors():
    cfg, _ = _cfgs()
    ds = SyntheticPoseDataset(**DS)
    want = _batches(DataLoader(ds, cfg, 2, seed=5), epoch=1)
    got = list(prefetch_to_device(iter(want), "cpu", size=2))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            assert np.array_equal(a[k].numpy(), b[k]), k


def test_prefetch_raises_the_producers_error():
    def host_iter():
        yield {"x": np.zeros(3, np.float32)}
        raise ValueError("encode failed")

    it = prefetch_to_device(host_iter(), "cpu")
    assert next(it)["x"].shape == (3,)
    with pytest.raises(ValueError, match="encode failed"):
        next(it)


def test_prefetch_consumer_may_stop_early():
    batches = ({"x": np.full(2, i, np.float32)} for i in range(100))
    it = prefetch_to_device(batches, "cpu", size=2)
    assert float(next(it)["x"][0]) == 0.0
    it.close()  # the producer thread finishes instead of blocking on put
