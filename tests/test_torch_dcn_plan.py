"""The forward kernels' launch plan (``ops/dcn_cuda.forward_plan``) and the
build key of the kernel libraries, on the CPU.

The plan is the shape logic of the forward kernels (csrc/dcn_fused.cu,
``dcn_gemm_wgmma`` in bf16 and ``dcn_gemm_f32`` in float32): which block
owns which pixels, output columns and part of the 9*Cin reduction, how much
shared memory it asks for, how many kernels one K1 call launches.  The kernel checks the plan it is given; these
tests check that every plan covers its problem exactly once, at the dla_34
site shapes and at the ragged shapes of the card tests.
"""

import hashlib

import pytest
import torch

from centerpose_tpu_torch.ops import dcn_cuda as dc

from _torch_port import release_compiled, release_resources  # noqa: F401

# dla_34's DCN sites: (Cin, Cout, output stride); H = W = resolution / stride
SITES = [(512, 256, 32), (256, 256, 16), (256, 128, 16), (128, 128, 8),
         (128, 64, 8), (256, 64, 16), (64, 64, 4)]
# the card tests' ragged shapes: (B, H, W, Cin, Cout)
RAGGED = [(1, 5, 7, 3, 5), (2, 9, 13, 40, 70), (1, 16, 16, 512, 256),
          (2, 32, 48, 96, 130), (2, 64, 160, 64, 64), (1, 128, 136, 3, 5),
          (2, 96, 96, 128, 128)]
DTYPES = [torch.bfloat16, torch.float32]


def _check_plan(dtype, b, h, w, cin, cout):
    plan = dc.forward_plan(dtype, b, h, w, cin, cout)
    npix = b * h * w
    tile = plan["tile_m"]
    # the tiles cover every pixel once: the last tile holds the last pixel
    assert plan["tiles"] * tile >= npix > (plan["tiles"] - 1) * tile
    # the output columns: a block's columns padded to whole 64-column
    # sub-tiles, up to 256; column tiles of that width cover Cout
    assert plan["n_pad"] == 64 * -(-min(cout, 256) // 64)
    assert plan["col_tiles"] == -(-cout // plan["n_pad"])
    assert plan["n_pad"] * plan["col_tiles"] >= cout
    assert cout > plan["n_pad"] * (plan["col_tiles"] - 1)
    assert plan["launches"] == dc.KERNELS_PER_CALL[dtype] == 1
    assert plan["smem"] <= 232448
    # the reduction: chunks (tap, channel slice) in ranges that partition
    # them, so each (tap, input channel) is summed by exactly one rank
    ranges = plan["chunk_ranges"]
    assert len(ranges) == plan["split"]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan["chunks"]
    assert all(a < b_ for a, b_ in ranges)
    assert all(r[1] == r2[0] for r, r2 in zip(ranges, ranges[1:]))
    assert plan["chunks"] == 9 * plan["slices"]
    covered = []
    for a, b_ in ranges:
        for j in range(a, b_):
            k, sl = divmod(j, plan["slices"])
            c0 = sl * plan["chunk"]
            covered += [(k, c) for c in range(c0, min(c0 + plan["chunk"],
                                                      cin))]
    assert sorted(covered) == [(k, c) for k in range(9) for c in range(cin)]
    # the output rows of a tile: each summed and written by one rank
    rows = [r for a, b_ in plan["reduce_rows"] for r in range(a, b_)]
    assert rows == list(range(tile))
    assert plan["split"] <= 8  # a cluster's portable size
    assert 2 <= plan["stages"] <= 4
    if plan["n_pad"] <= 128:  # two blocks fit on an SM
        assert 2 * (plan["smem"] + 1024) <= 233472
    if plan["kernel"] == "wgmma":
        assert dtype == torch.bfloat16 and plan["chunk"] == 64
        assert plan["col_tiles"] == 1
        assert plan["grid"] == (plan["tiles"] * plan["split"],)
        assert plan["smem"] == dc.fwd_smem_bytes(plan["n_pad"],
                                                 plan["stages"])
        # a stage: A [64 x 64] and B [64 x n_pad] bf16
        ring = plan["stages"] * (tile * plan["chunk"] * 2
                                 + plan["chunk"] * plan["n_pad"] * 2)
    else:
        # float32: one FFMA block per (tile, column tile), chunks of 32
        # channels (a 128-byte row), split over a cluster like bf16
        assert plan["kernel"] == "ffma" and dtype == torch.float32
        assert plan["chunk"] == 32
        assert plan["grid"] == (plan["tiles"] * plan["split"],
                                plan["col_tiles"])
        assert plan["smem"] == dc.fwd_f32_smem_bytes(plan["n_pad"],
                                                     plan["stages"])
        # a stage: A [64 x 36] (pixel-major, padded rows) and B [32 x
        # n_pad] f32
        ring = plan["stages"] * (tile * 36 * 4
                                 + plan["chunk"] * plan["n_pad"] * 4)
    # a split block's f32 partial [64][n_pad + 4] fits in its ring
    assert plan["split"] == 1 or ring >= tile * (plan["n_pad"] + 4) * 4
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("res", [384, 512, 640])
@pytest.mark.parametrize("cin,cout,stride", SITES)
def test_plan_covers_each_dla34_site(cin, cout, stride, res, dtype):
    hw = res // stride
    for b in (1, 8):
        _check_plan(dtype, b, hw, hw, cin, cout)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", RAGGED)
def test_plan_covers_ragged_shapes(shape, dtype):
    _check_plan(dtype, *shape)


def test_plan_splits_small_sites_only():
    """The reduction is split where the tiles leave SMs idle (every
    W <= 64 site at batch 1, 512->256 @16 at batch 8) and not where they
    fill the card (64->64 @128 at batch 8), in both dtypes; float32 also
    splits the W = 32 sites at batch 8 (its 64-wide tiles are as few)."""
    for dt in DTYPES:
        for cin, cout, stride in SITES:
            hw = 512 // stride
            if hw <= 64:
                assert dc.forward_plan(dt, 1, hw, hw, cin, cout)["split"] > 1
        assert dc.forward_plan(dt, 8, 16, 16, 512, 256)["split"] > 1
        assert dc.forward_plan(dt, 8, 128, 128, 64, 64)["split"] == 1
        assert dc.forward_plan(dt, 8, 64, 64, 128, 64)["split"] == 1
    f32 = torch.float32
    assert dc.forward_plan(f32, 1, 128, 128, 64, 64)["split"] == 1
    assert [dc.forward_plan(f32, 8, 32, 32, cin, cout)["split"]
            for cin, cout in ((256, 256), (256, 128), (256, 64))] == [1, 2, 2]


@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 16, 16, 64, 300),
                                            (2, 40, 40, 32, 520),
                                            (1, 5, 7, 3, 257)])
def test_f32_plan_takes_any_cout_in_column_tiles(b, h, w, cin, cout):
    """Past 256 columns the float32 kernel takes column tiles of 256 (the
    grid's second dimension, each gathering its tile again); bfloat16
    refuses the shape."""
    plan = _check_plan(torch.float32, b, h, w, cin, cout)
    assert plan["n_pad"] == 256 and plan["col_tiles"] == -(-cout // 256)
    with pytest.raises(ValueError):
        dc.forward_plan(torch.bfloat16, b, h, w, cin, cout)


def test_plan_is_the_same_on_every_call():
    args = [(dt, b, 512 // s, 512 // s, cin, cout) for cin, cout, s in SITES
            for b in (1, 8) for dt in DTYPES]
    first = [dc.forward_plan(*a) for a in args]
    dc.forward_plan.cache_clear()
    again = [dc.forward_plan(*a) for a in args]
    assert first == again
    assert [dc.forward_plan(*a) for a in args] == first


def test_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        dc.forward_plan(torch.bfloat16, 1, 8, 8, 64, 257)
    with pytest.raises(ValueError):
        dc.forward_plan(torch.bfloat16, 1, 8, 8, 0, 64)
    with pytest.raises(TypeError):
        dc.forward_plan(torch.float16, 1, 8, 8, 64, 64)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every library that includes it, directly
    or through another header; an unrelated file does not."""
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    monkeypatch.setattr(dc, "_SOURCES", {"k": src})
    assert dc._local_headers(src) == [(tmp_path / "a.cuh").resolve(),
                                      (tmp_path / "b.cuh").resolve()]
    before = dc.library_path("k")
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert dc.library_path("k") == before
    (tmp_path / "b.cuh").write_text("int b2;\n")
    changed = dc.library_path("k")
    assert changed != before and changed.parent == before.parent
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n// x\n')
    assert dc.library_path("k") != changed


def test_library_path_of_the_port_hashes_its_header():
    """Both kernel sources include the shared Hopper header, and their
    build key covers it."""
    hdr = (dc._PKG / "csrc" / "dcn_hopper.cuh").resolve()
    for name in ("fwd", "bwd"):
        assert hdr in dc._local_headers(dc._SOURCES[name])
        h = hashlib.sha256(" ".join(dc._NVCC_FLAGS).encode())
        h.update(dc._SOURCES[name].read_bytes())
        # the key of the source alone (the old key) is not the key
        assert h.hexdigest()[:16] not in dc.library_path(name).name
