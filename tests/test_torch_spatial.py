"""Spatial sharding of the port's serving forward (``parallel/mesh.py:
create_mesh_2d, spatial_sharding``, ``parallel/spatial.py``) against the
reference's GSPMD-partitioned forward (``tests/test_spatial_shard.py``) and
the port's one-process forward.

The row arithmetic runs in this process; the sharded forwards run on gloo
ranks on the CPU (``tests/_torch_dp.py``, job ``spatial``), where the DCN
sites take the kernels' plain versions.  Tolerances: float32 ``atol=2e-5``
as the reference's test, unless a case says otherwise."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from centerpose_tpu_torch.parallel import spatial

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_dp import run_ranks
from _torch_port import (FAST_COMPILE, jax_cfg, jax_variables,
                         port_state_dict, rel_err)

ATOL = 2e-5

# Every window along the rows the factory's models use: (kernel, stride,
# dilation, padding (top, bottom), transposed): the 3x3 / 5x5 / 7x7 convs,
# plain and strided, the 1x1s, a dilated ConvBN, the deconv and the three
# bilinear upsamples (transposed, k = 2f, stride f, pad f // 2), the max
# pools (resnet/hardnet/shufflenet 3x3 s2 p1, DLA/hardnet 2x2 s2) and
# efficientnet's SAME pool (the extra row at the bottom).
WINDOWS = [
    (3, 1, 1, (1, 1), False), (3, 2, 1, (1, 1), False),
    (1, 1, 1, (0, 0), False), (1, 2, 1, (0, 0), False),
    (5, 1, 1, (2, 2), False), (5, 2, 1, (2, 2), False),
    (7, 1, 1, (3, 3), False), (7, 2, 1, (3, 3), False),
    (3, 1, 2, (2, 2), False), (2, 2, 1, (0, 0), False),
    (3, 2, 1, (0, 1), False),
    (4, 2, 1, (1, 1), True), (8, 4, 1, (2, 2), True),
    (16, 8, 1, (4, 4), True),
]


def _op(win: spatial.Window, x: torch.Tensor, pad_rows: tuple):
    """The windowed op (a conv with a seeded weight, transposed or not)
    on ``x`` with ``pad_rows`` rows of padding (plain) or torch's
    ``padding`` (transposed); the columns padded as the rows."""
    g = torch.Generator().manual_seed(0)
    c = x.shape[1]
    k = win.kernel
    if win.transposed:
        w = torch.randn(c, 2, k, k, generator=g, dtype=torch.float64)
        p = win.pad[0]
        return F.conv_transpose2d(x, w, stride=win.stride,
                                  padding=(pad_rows[0], p))
    w = torch.randn(2, c, k, k, generator=g, dtype=torch.float64)
    cols = win.pad
    x = F.pad(x, (cols[0], cols[1], pad_rows[0], pad_rows[1]))
    return F.conv2d(x, w, stride=win.stride, dilation=win.dilation)


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("k,s,d,pad,transposed", WINDOWS)
def test_window_rows_slice_the_unsharded_op(k, s, d, pad, transposed,
                                            count):
    """Each shard's output rows, computed from the input rows
    ``shard_halo`` names (zeros past the image) with no row padding and
    cropped at its offset, equal the unsharded op's output cut into
    shards, bit for bit (float64)."""
    win = spatial.Window(k, s, d, pad, transposed)
    h = 32
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, h * count, 12)))
    whole = _op(win, x, pad)
    assert whole.shape[2] == spatial.out_rows(win, h * count)
    ho = whole.shape[2] // count
    for i in range(count):
        top, bottom, offset, rows_out = spatial.shard_halo(win, h, i, count)
        assert rows_out == ho
        lo, hi = i * h - top, (i + 1) * h + bottom
        above = max(-lo, 0)
        rows = F.pad(x, (0, 0, above, max(hi - h * count, 0)))
        rows = rows[:, :, lo + above:hi + above]
        got = _op(win, rows, (0, 0))[:, :, offset:offset + ho]
        assert torch.equal(got, whole[:, :, i * ho:(i + 1) * ho]), i


def test_uneven_split_raises():
    """A height that does not split evenly over the shards raises."""
    with pytest.raises(ValueError, match="split"):
        spatial.shard_halo(spatial.Window(3, 2, 1, (1, 1)), 3, 0, 2)


def _save(tmp_path, specs) -> str:
    path = tmp_path / "case.pt"
    torch.save(specs, path)
    return str(path)


def _heads(out):
    return {k: v.float().numpy() for k, v in out.items()}


def test_res18_2x4_matches_reference_and_one_process(tmp_path):
    """The mirror of ``tests/test_spatial_shard.py``: res_18 at 128x128,
    the reference's ``init_model(PRNGKey(0))`` weights carried across, the
    same input, a 2 x 4 mesh: 8 ranks against the reference's 2 x 4
    sharded forward on its 8 virtual devices, and against the port's
    one-process forward."""
    from centerpose_tpu.config import load_config
    from centerpose_tpu.models.factory import create_model, init_model
    from centerpose_tpu.parallel.mesh import (create_mesh_2d, replicated,
                                              spatial_sharding)

    cfg = load_config(opts=["model.name", "res_18", "model.input_res", "128",
                            "model.output_res", "32"])
    model = create_model(cfg)
    variables = init_model(model, jax.random.PRNGKey(0), 128)
    x = np.random.default_rng(0).normal(size=(2, 128, 128, 3)).astype(
        np.float32)
    mesh = create_mesh_2d(2, 4)
    fwd = jax.jit(lambda v, a: model.apply(v, a, train=False),
                  in_shardings=(replicated(mesh), spatial_sharding(mesh)))
    want = fwd(jax.device_put(variables, replicated(mesh)),
               jax.device_put(jnp.asarray(x), spatial_sharding(mesh)))
    spec = {"name": "res_18", "res": 128, "x": torch.from_numpy(x),
            "state_dict": port_state_dict(variables)}
    ranks = run_ranks("spatial", 8, tmp_path, case=_save(tmp_path, [spec]),
                      data=2, spatial=4)
    got = _heads(ranks[0][0]["sharded"])
    one = _heads(ranks[0][0]["one"])
    for r in ranks[1:]:  # every rank holds the gathered heads
        assert all(np.array_equal(v, r[0]["sharded"][k].numpy())
                   for k, v in got.items())
    for head in want:
        np.testing.assert_allclose(got[head], np.asarray(want[head]),
                                   atol=ATOL, err_msg=head)
        np.testing.assert_allclose(got[head], one[head], atol=ATOL,
                                   err_msg=head)


@pytest.fixture(scope="module")
def dla34_reference():
    """The reference's dla_34 (``xla``, the snapshot) at 128x128 on a 1 x 4
    mesh of its virtual devices, and the input (batch 2)."""
    from centerpose_tpu.models.factory import create_model
    from centerpose_tpu.parallel.mesh import (create_mesh_2d, replicated,
                                              spatial_sharding)

    x = np.random.default_rng(0).normal(size=(2, 128, 128, 3)).astype(
        np.float32)
    model = create_model(jax_cfg(128, "xla"))
    variables = jax_variables()
    mesh = create_mesh_2d(1, 4)
    fwd = jax.jit(lambda v, a: model.apply(v, a, train=False),
                  in_shardings=(replicated(mesh), spatial_sharding(mesh)))
    args = (jax.device_put(variables, replicated(mesh)),
            jax.device_put(jnp.asarray(x), spatial_sharding(mesh)))
    out = fwd.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return x, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("n_spatial", [2, 4])
def test_dla34_row_shards(n_spatial, dla34_reference, tmp_path):
    """dla_34 at 128x128 from the snapshot on 1 x 2 and 1 x 4 meshes (one
    row per shard at stride 32: every halo spans shards), under ``xla``
    (every site unclamped: the halo from the offsets) and ``pallas_full``
    (om-fused, clamped and unclamped sites): against the port's
    one-process forward, and ``xla`` against the reference's 1 x 4
    sharded forward at the port's one-process distance to the reference's
    one-process forward (max error under 1e-4 of the head's largest value,
    ``tests/test_torch_model.py``: f32 convs and DCN sums in another
    order)."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    from _torch_port import NPZ

    x, want = dla34_reference
    sd = state_dict_from_npz(NPZ)
    specs = [{"name": "dla_34", "res": 128, "head_conv": 256,
              "dcn_impl": impl, "x": torch.from_numpy(x), "state_dict": sd}
             for impl in ("xla", "pallas_full")]
    ranks = run_ranks("spatial", n_spatial, tmp_path,
                      case=_save(tmp_path, specs), data=1, spatial=n_spatial)
    for impl, res in zip(("xla", "pallas_full"), ranks[0]):
        got, one = _heads(res["sharded"]), _heads(res["one"])
        for head in got:
            np.testing.assert_allclose(got[head], one[head], atol=ATOL,
                                       err_msg=f"{impl} {head}")
            if impl == "xla":
                assert rel_err(got[head], want[head]) < 1e-4, head


EDGE_DY = [9.0, 5.5]


@pytest.fixture(scope="module")
def clamp_edge(tmp_path_factory):
    """``_torch_dp._spatial_edge`` on 4 ranks (one launch for every dy and
    mutant)."""
    tmp = tmp_path_factory.mktemp("edge")
    return run_ranks("spatial_edge", 4, tmp, shape="1,8,16,128",
                     dy=",".join(map(str, EDGE_DY)))


@pytest.mark.parametrize("dy", EDGE_DY)
def test_dcn_clamp_edge_reads_the_global_policy(dy, clamp_edge):
    """One ``pallas_full`` DCN site, 8 -> 8 channels, 16 x 128 over 4
    shards of 4 rows: globally om-fused and clamped at R = 6 (on 4 rows
    alone the reference's policy would take the unclamped fallback).
    Every tap's dy is +-``dy``: 9 clamps to 6, so the rows beside each
    shard boundary sample 6 rows into the neighbours (7 with the tap row);
    5.5 is inside R, and its bilinear corner below reaches R + 1.  The
    sharded output equals the one-process output; the same run with a
    halo of 1 row, or (dy 9) with the policy of the shard's height, does
    not."""
    assert all(r["policy_rows"] and set(r["policy_rows"]) == {16}
               for r in clamp_edge)
    res = clamp_edge[0][dy]
    one = res["one"].numpy()
    np.testing.assert_allclose(res["sharded"].numpy(), one, atol=ATOL)
    mutants = ["halo1"] + (["local"] if dy > 6 else [])
    for mutant in mutants:
        assert np.abs(res[mutant].numpy() - one).max() > 1e-2, mutant


FACTORY = ["res_18", "res_34", "res_50", "res_101", "res_152", "dla_34",
           "hrnet_w32", "hrnet_w48", "mobilenetv2", "mobilenetv3",
           "shufflenetv2", "hardnet", "darknet", "efficientnet"]


@pytest.fixture(scope="module")
def factory_on_row_shards(tmp_path_factory):
    """Each factory name at 64x64, batch 1, its seeded init, on a 1 x 2
    mesh (one launch of two ranks for all 14) with the one-process
    forward of each."""
    tmp = tmp_path_factory.mktemp("factory")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    specs = [{"name": n, "res": 64, "x": x} for n in FACTORY]
    ranks = run_ranks("spatial", 2, tmp, case=_save(tmp, specs), data=1,
                      spatial=2)
    return dict(zip(FACTORY, ranks[0]))


# The seeded inits' heads range from ~0.1 to ~1e6 in magnitude with depth
# (no trained BatchNorm statistics), so the factory cases are held
# relative to each head's largest value (at least 1): both forwards sum
# the same f32 products in another order where a conv runs on a shard's
# rows, which read up to 3.6e-6 (res_152); a missing or misplaced halo
# row moves the boundary rows by their own size.
RTOL_FACTORY = 1e-5


@pytest.mark.parametrize("name", FACTORY)
def test_every_factory_name_on_row_shards(name, factory_on_row_shards):
    res = factory_on_row_shards[name]
    got, one = _heads(res["sharded"]), _heads(res["one"])
    assert got.keys() == one.keys() and got
    for head in got:
        assert got[head].shape == one[head].shape
        scale = max(np.abs(one[head]).max(), 1.0)
        err = np.abs(got[head] - one[head]).max()
        assert err <= RTOL_FACTORY * scale, (head, err, scale)
