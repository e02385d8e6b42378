"""Spatial sharding of the port's serving forward (``parallel/mesh.py:
create_mesh_2d, spatial_sharding``, ``parallel/spatial.py``) against the
reference's GSPMD-partitioned forward (``tests/test_spatial_shard.py``) and
the port's one-process forward.

The row arithmetic (even and uneven splits, the halo assembled as the
exchange hands the rows over) runs in this process; the sharded forwards
run on gloo ranks on the CPU (``tests/_torch_dp.py``, job ``spatial``),
where the DCN sites take the kernels' plain versions: even splits, and
heights whose stride-32 rows do not split evenly (160x160 and 96x96 on
1 x 4, the latter with a rank of no rows; 96x96 on 1 x 2), which the
reference's GSPMD forward pads.  Tolerances: float32 ``atol=2e-5`` as the
reference's test, unless a case says otherwise."""

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
        top, bottom, offset, rows_out = spatial.shard_halo(win, (h,) * count,
                                                           i)
        assert rows_out == ho
        lo, hi = i * h - top, (i + 1) * h + bottom
        above = max(-lo, 0)
        rows = F.pad(x, (0, 0, above, max(hi - h * count, 0)))
        rows = rows[:, :, lo + above:hi + above]
        got = _op(win, rows, (0, 0))[:, :, offset:offset + ho]
        assert torch.equal(got, whole[:, :, i * ho:(i + 1) * ho]), i


# Uneven splits of one level, each shard's rows: a level of 8 rows per
# stride-32 row (stride 4) with 5 cells over 4 shards (2/1/1/1), 3 over 4
# (1/1/1/0: a shard with no rows), 3 over 2 (2/1) and 34 over 4 (9/9/8/8,
# a 1088-row image).
UNEVEN = [(16, 8, 8, 8), (8, 8, 8, 0), (16, 8), (72, 72, 64, 64)]


def _exchange(x, heights, reach):
    """Every shard's rows of ``x`` and the pieces the exchange hands
    over (``spatial.edge_rows`` of each), stacked as ``halo`` gathers
    them."""
    starts = np.cumsum((0,) + tuple(heights))
    blocks = [x[:, :, a:a + h] for a, h in zip(starts, heights)]
    return blocks, torch.stack([spatial.edge_rows(b, reach) for b in blocks])


@pytest.mark.parametrize("heights", UNEVEN, ids=lambda h: "-".join(map(
    str, h)))
@pytest.mark.parametrize("k,s,d,pad,transposed", WINDOWS)
def test_window_rows_on_uneven_shards(k, s, d, pad, transposed, heights):
    """On shards of unequal (and no) rows: each shard's output rows,
    computed from its halo as ``spatial.assemble`` puts it together out of
    every shard's ``edge_rows`` (padded to the largest halo of any shard,
    as the exchange moves them), with no row padding and cropped at its
    offset, equal the unsharded op's output cut as ``split_out`` cuts it,
    bit for bit (float64).  A shard with no rows has no output rows."""
    win = spatial.Window(k, s, d, pad, transposed)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, sum(heights), 12)))
    whole = _op(win, x, pad)
    outs = spatial.split_out(win, heights)
    assert sum(outs) == whole.shape[2]
    halos = [spatial.shard_halo(win, heights, i) for i in range(len(heights))]
    reach = (max(max(t[0], 0) for t in halos),
             max(max(t[1], 0) for t in halos))
    blocks, pieces = _exchange(x, heights, reach)
    lo = 0
    for i, (top, bottom, offset, ho) in enumerate(halos):
        assert ho == outs[i] and bool(ho) == bool(heights[i])
        if not ho:
            continue
        rows = spatial.assemble(blocks[i], pieces, heights, i, top, bottom,
                                reach[0])
        got = _op(win, rows, (0, 0))[:, :, offset:offset + ho]
        assert torch.equal(got, whole[:, :, lo:lo + ho]), i
        lo += ho


@pytest.mark.parametrize("heights", [(2, 1, 1, 1), (1, 1, 1, 0), (9, 9, 8, 8),
                                     (8, 7)],
                         ids=lambda h: "-".join(map(str, h)))
def test_halo_spans_unequal_shards(heights):
    """A halo of 7 rows each way (a clamped DCN site's R + 1 at R = 6) at
    the stride-32 level of the uneven splits: each shard's rows with the
    halo, from the shards above and below over as many as it spans (past
    a shard of no rows too), zero past the image, equal the zero-padded
    image's rows, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 2, sum(heights), 5)))
    reach = (7, 7)
    blocks, pieces = _exchange(x, heights, reach)
    padded = F.pad(x, (0, 0, 7, 7))
    lo = 0
    for i, h in enumerate(heights):
        got = spatial.assemble(blocks[i], pieces, heights, i, 7, 7, 7)
        assert torch.equal(got, padded[:, :, lo:lo + h + 14]), i
        lo += h


@pytest.mark.parametrize("h,count,rows", [
    (160, 4, (64, 32, 32, 32)), (96, 4, (32, 32, 32, 0)),
    (480, 2, (256, 224)), (1088, 4, (288, 288, 256, 256))])
def test_row_split_takes_whole_cells(h, count, rows):
    """``row_split``: whole stride-32 rows, the earlier shards one more."""
    assert spatial.row_split(h, count) == rows


@pytest.mark.parametrize("h,w,count,condition", [
    (160, 64, 3, "divisible by the shard count"),
    (144, 64, 4, "height must be a multiple of 32"),
    (96, 100, 4, "width must be a multiple of 32")])
def test_refused_heights_raise(h, w, count, condition):
    """What the split refuses, through the sharding's public ``shard``: a
    height the shard count does not divide (as the reference's
    ``device_put`` of ``P("data", "spatial")``), one that is not a multiple
    of the model's stride 32, and a width that is not where a shard gets
    no rows (such a shard reads its levels' heights from their widths);
    the message names the condition."""
    from centerpose_tpu_torch.parallel.mesh import Mesh2D, spatial_sharding

    sharding = spatial_sharding(Mesh2D(1, count))
    with pytest.raises(ValueError, match=condition):
        sharding.shard(torch.zeros(1, h, w, 3))


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


def _dla34_gspmd(res: int):
    """The reference's dla_34 (``xla``, the snapshot) at res x res on a
    1 x 4 mesh of its virtual devices (GSPMD pads the uneven levels), and
    the input (batch 2)."""
    from centerpose_tpu.models.factory import create_model
    from centerpose_tpu.parallel.mesh import (create_mesh_2d, replicated,
                                              spatial_sharding)

    x = np.random.default_rng(0).normal(size=(2, res, res, 3)).astype(
        np.float32)
    model = create_model(jax_cfg(res, "xla"))
    variables = jax_variables()
    mesh = create_mesh_2d(1, 4)
    fwd = jax.jit(lambda v, a: model.apply(v, a, train=False),
                  in_shardings=(replicated(mesh), spatial_sharding(mesh)))
    args = (jax.device_put(variables, replicated(mesh)),
            jax.device_put(jnp.asarray(x), spatial_sharding(mesh)))
    out = fwd.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)
    return x, {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def dla34_reference():
    """``_dla34_gspmd`` at 128x128 (one stride-32 row per shard)."""
    return _dla34_gspmd(128)


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


FACTORY = ["res_18", "res_34", "res_50", "res_101", "res_152", "dla_34",
           "hrnet_w32", "hrnet_w48", "mobilenetv2", "mobilenetv3",
           "shufflenetv2", "hardnet", "darknet", "efficientnet"]


# The uneven dla_34 cases on 1 x 4, (H, W, dcn_impl): 160x160 (5 stride-32
# rows: 2/1/1/1) and 96x96 (3: 1/1/1/0, a rank with no rows), each under
# ``xla`` and ``pallas_full`` (K2's path: no site is om-fused at these
# widths), and 96x128 under ``pallas_full`` (K1's path at the stride-4
# sites, width 32, R = 12).
UNEVEN_DLA = [(160, 160, "xla"), (160, 160, "pallas_full"), (96, 96, "xla"),
              (96, 96, "pallas_full"), (96, 128, "pallas_full")]


@pytest.fixture(scope="module")
def uneven_on_four_ranks(tmp_path_factory):
    """The reference's 1 x 4 GSPMD forward at 160x160, and one launch of
    four ranks for every ``UNEVEN_DLA`` case (the snapshot) and every
    factory name at 96x96 (its seeded init, batch 1): (the reference's
    heads, {case: results}), a case being ``UNEVEN_DLA``'s or a name."""
    from centerpose_tpu_torch.weights import state_dict_from_npz

    from _torch_port import NPZ

    tmp = tmp_path_factory.mktemp("uneven")
    x160, want = _dla34_gspmd(160)
    x96 = np.random.default_rng(4).normal(size=(2, 96, 128, 3)).astype(
        np.float32)
    sd = state_dict_from_npz(NPZ)
    specs = [{"name": "dla_34", "res": h, "head_conv": 256,
              "dcn_impl": impl, "state_dict": sd,
              "x": torch.from_numpy(x160 if h == 160 else x96[:, :, :w])}
             for h, w, impl in UNEVEN_DLA]
    specs += [{"name": n, "res": 96, "x": torch.from_numpy(x96[:1, :, :96])}
              for n in FACTORY]
    ranks = run_ranks("spatial", 4, tmp, case=_save(tmp, specs), data=1,
                      spatial=4)
    for r in ranks[1:]:  # every rank holds the gathered heads
        for mine, first in zip(r, ranks[0]):
            assert all(torch.equal(v, first["sharded"][k])
                       for k, v in mine["sharded"].items())
    return want, dict(zip(UNEVEN_DLA + FACTORY, ranks[0]))


@pytest.mark.parametrize("h,w,impl", UNEVEN_DLA)
def test_dla34_uneven_row_shards(h, w, impl, uneven_on_four_ranks):
    """dla_34 from the snapshot on 1 x 4 where the rows do not split
    evenly: 160x160 (2/1/1/1 stride-32 rows), 96x96 and 96x128 (1/1/1/0,
    one rank holds no rows and still enters every exchange), under
    ``xla`` (every site unclamped) and ``pallas_full``: equal to the
    port's one-process forward (``ATOL``) on every rank, and at 160x160
    under ``xla`` within 1e-4 of the reference's 1 x 4 GSPMD forward (as
    ``test_dla34_row_shards``)."""
    want, cases = uneven_on_four_ranks
    case = cases[h, w, impl]
    got, one = _heads(case["sharded"]), _heads(case["one"])
    for head in got:
        assert got[head].shape == (2, h // 4, w // 4, one[head].shape[3])
        np.testing.assert_allclose(got[head], one[head], atol=ATOL,
                                   err_msg=f"{impl} {head}")
        if h == 160 and impl == "xla":
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


@pytest.fixture(scope="module")
def factory_on_row_shards(tmp_path_factory):
    """Each factory name at 64x64 (even rows) and 96x96 (3 stride-32 rows:
    2/1), batch 1, its seeded init, on a 1 x 2 mesh (one launch of two
    ranks for all 28) with the one-process forward of each: {(name,
    res): results}."""
    tmp = tmp_path_factory.mktemp("factory")
    cases = [(n, res) for res in (64, 96) for n in FACTORY]
    specs = [{"name": n, "res": res, "x": torch.from_numpy(
        np.random.default_rng(2).normal(size=(1, res, res, 3)).astype(
            np.float32))} for n, res in cases]
    ranks = run_ranks("spatial", 2, tmp, case=_save(tmp, specs), data=1,
                      spatial=2)
    return dict(zip(cases, ranks[0]))


# The seeded inits' heads range from ~0.1 to ~1e6 in magnitude with depth
# (no trained BatchNorm statistics), so the factory cases are held
# relative to each head's largest value (at least 1): both forwards sum
# the same f32 products in another order where a conv runs on a shard's
# rows, which read up to 3.6e-6 (res_152); a missing or misplaced halo
# row moves the boundary rows by their own size.
RTOL_FACTORY = 1e-5


def _factory_case(res):
    got, one = _heads(res["sharded"]), _heads(res["one"])
    assert got.keys() == one.keys() and got
    for head in got:
        assert got[head].shape == one[head].shape
        scale = max(np.abs(one[head]).max(), 1.0)
        err = np.abs(got[head] - one[head]).max()
        assert err <= RTOL_FACTORY * scale, (head, err, scale)


@pytest.mark.parametrize("name", FACTORY)
def test_every_factory_name_on_row_shards(name, factory_on_row_shards):
    _factory_case(factory_on_row_shards[name, 64])


@pytest.mark.parametrize("name", FACTORY)
def test_every_factory_name_on_uneven_row_shards(name, factory_on_row_shards):
    """96x96 on 1 x 2: the first rank holds 64 rows, the second 32."""
    _factory_case(factory_on_row_shards[name, 96])


@pytest.mark.parametrize("name", FACTORY)
def test_every_factory_name_with_a_rank_of_no_rows(name,
                                                   uneven_on_four_ranks):
    """96x96 on 1 x 4: 32/32/32/0 rows, the last rank with none enters
    every exchange (and the squeeze-excite means) and adds nothing."""
    _factory_case(uneven_on_four_ranks[1][name])
