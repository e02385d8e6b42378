"""Small cells for the CPU tests: the benchmark's configurations and
traffic at 128x128 frames, batch 2, so that a run of the harness fits in
a test."""

from __future__ import annotations

import copy

from benchmark.harness.manifest import ROOT, Manifest
from benchmark.reference import nets

FRAME = 128
TRAFFIC = {"frame": FRAME, "batch": 2, "pool": 4, "distinct": 2,
           "warmup_batches": 1, "trace_batches": 2, "check_batches": 2}
# DLA-34's DCN sites at a 128x128 input: (h = w, cin, cout)
DLA_SITES_128 = ((4, 512, 256), (8, 256, 256), (8, 256, 128),
                 (16, 128, 128), (16, 128, 64), (8, 256, 64),
                 (32, 64, 64))


def dcn_r_128(cfg: dict) -> dict:
    """The clamp radius of each DLA-34 site at 128x128 as the port's
    policy gives it (the port's own functions, read here in a test)."""
    from centerpose_tpu_torch.ops.dcn_cuda import (site_max_dy,
                                                   site_om_fused,
                                                   train_site_max_dy)

    impl = cfg["program"]["model"].get("dcn_impl", "xla")
    out = {}
    for hw, cin, cout in DLA_SITES_128:
        fused = site_om_fused(hw, hw, cin, cout, impl)
        r = (site_max_dy if fused else train_site_max_dy)(hw, hw, cin, cout,
                                                          impl)
        out[nets.site_key(hw, hw, cin, cout)] = r
    return out


def context(cell_name: str, seconds: float = 0.3, trace: bool = False,
            seed: int = 5, **traffic):
    """A run's ``Context`` for ``cell_name`` on the CPU at the small size."""
    from benchmark.run import Context

    m = Manifest()
    cell = m.cell(cell_name)
    cfg = copy.deepcopy(m.config(cell))
    if cfg["arch"] == "dla_34":
        cfg["dcn_r"] = dcn_r_128(cfg)
    tr = dict(m.traffic(cell), **(TRAFFIC if cell["traffic"].startswith("stream") else {}), **traffic)
    over = {"model": {"input_res": FRAME, "output_res": FRAME // 4}}
    return Context(ROOT, cell, cfg, tr, m.limits(cell), seed, seconds, trace,
                   device="cpu", overrides=over)


def train_context(seconds: float = 0.3, trace: bool = False, seed: int = 5,
                  **traffic):
    """The training cell's ``Context`` on the CPU at 128x128, batch 2."""
    tr = {"frame": FRAME, "batch": 2, "pool": 3, "warmup_steps": 4,
          "trace_steps": 1, **traffic}
    ctx = context("dla34-train-b32", seconds, trace, seed)
    ctx.traffic.update(tr)
    return ctx
