"""The order the float32 forward kernel sums in, held against the
reference on the CPU.

``dcn_gemm_f32`` (csrc/dcn_fused.cu) computes each output as the sum, in
cluster-rank order, of the partials of the ranks' (tap, 32-channel) chunk
ranges (``ops/dcn_cuda.forward_plan``: ``chunk_ranges``), plus the bias.
Here the plain version's column (``ops/dcn.dcn_v2_columns``) is cut into
the plan's chunks, each chunk's product taken alone, the chunks summed
rank by rank and the ranks in order; the result must be the JAX package's
``dcn_v2`` in float32.  The shapes are the 7 dla_34 sites at 128x128 input
(full channel widths, so the chunk sequence is the real one; few pixels,
so most plans split), batch 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centerpose_tpu.ops.dcn import dcn_v2 as j_dcn_v2
from centerpose_tpu_torch.ops import dcn_cuda as dc
from centerpose_tpu_torch.ops.dcn import dcn_v2_columns

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_port import rel_err

# dla_34's DCN sites: (Cin, Cout, output stride)
SITES = [(512, 256, 32), (256, 256, 16), (256, 128, 16), (128, 128, 8),
         (128, 64, 8), (256, 64, 16), (64, 64, 4)]


def plan_order_forward(x, offset, mask, weight, bias, plan):
    """y as the float32 kernel sums it: per column tile, each rank's chunks
    (tap j // slices, channels (j % slices) * chunk ..) summed in chunk
    order into its partial, the partials summed in rank order, + bias."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    cols = dcn_v2_columns(x, offset, mask)  # [P, 9 * Cin] f32
    wmat = weight.reshape(9 * cin, cout)
    y = torch.empty(cols.shape[0], cout)
    for ct in range(plan["col_tiles"]):
        n0, n1 = ct * plan["n_pad"], min(cout, (ct + 1) * plan["n_pad"])
        out = None
        for j0, j1 in plan["chunk_ranges"]:
            part = torch.zeros(cols.shape[0], n1 - n0)
            for j in range(j0, j1):
                k, sl = divmod(j, plan["slices"])
                c0 = sl * plan["chunk"]
                rows = slice(k * cin + c0, k * cin + min(c0 + plan["chunk"],
                                                         cin))
                part = part + cols[:, rows] @ wmat[rows, n0:n1]
            out = part if out is None else out + part
        y[:, n0:n1] = out + bias[n0:n1]
    return y.reshape(b, h, w, cout)


@pytest.mark.parametrize("cin,cout,stride", SITES)
def test_plan_order_sum_matches_reference(cin, cout, stride):
    hw = 128 // stride
    b = 2
    r = np.random.default_rng(cin + cout + stride)
    x = r.normal(size=(b, hw, hw, cin)).astype(np.float32)
    off = (r.normal(size=(b, hw, hw, 18)) * 2.0).astype(np.float32)
    mask = (1 / (1 + np.exp(-r.normal(size=(b, hw, hw, 9))))).astype(
        np.float32)
    wgt = (r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = r.normal(size=(cout,)).astype(np.float32)
    plan = dc.forward_plan(torch.float32, b, hw, hw, cin, cout)
    assert plan["kernel"] == "ffma" and plan["chunk"] == 32
    got = plan_order_forward(*map(torch.from_numpy, (x, off, mask, wgt,
                                                     bias)), plan)
    want = np.asarray(j_dcn_v2(*map(jnp.asarray, (x, off, mask, wgt, bias))))
    assert rel_err(got.numpy(), want) <= 1e-5


def test_plan_order_covers_split_and_column_tiles():
    """The 7 scaled-down sites split their reduction (all over 4 or 8
    ranks), and a Cout past 256 takes two column tiles: the order the
    kernel sums in at those plans, against the reference."""
    splits = [dc.forward_plan(torch.float32, 2, 128 // s, 128 // s, cin,
                              cout)["split"] for cin, cout, s in SITES]
    assert min(splits) >= 4, splits
    r = np.random.default_rng(5)
    b, hw, cin, cout = 1, 8, 40, 300
    x = r.normal(size=(b, hw, hw, cin)).astype(np.float32)
    off = (r.normal(size=(b, hw, hw, 18)) * 2.0).astype(np.float32)
    mask = (1 / (1 + np.exp(-r.normal(size=(b, hw, hw, 9))))).astype(
        np.float32)
    wgt = (r.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = r.normal(size=(cout,)).astype(np.float32)
    plan = dc.forward_plan(torch.float32, b, hw, hw, cin, cout)
    assert plan["col_tiles"] == 2 and plan["split"] > 1
    got = plan_order_forward(*map(torch.from_numpy, (x, off, mask, wgt,
                                                     bias)), plan)
    want = np.asarray(j_dcn_v2(*map(jnp.asarray, (x, off, mask, wgt, bias))))
    assert rel_err(got.numpy(), want) <= 1e-5
