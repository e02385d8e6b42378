"""k1_roofline.serve: the om-fused DCN forward kernels' (K1) share of their
roofline in a traced serving stretch: the sum over the configuration's DCN
sites of the least time a K1 call can take (``harness/roofline.k1_bound``:
inputs read once, output written once, products at the dense peak), over
the device time of the K1 kernels found by name.  None where the stretch
ran no K1 kernel.  Moves ``serve_img_s``."""

import re

from benchmark.harness.roofline import k1_bound

# dcn_gemm_wgmma<NT, true> / dcn_gemm_f32<NT, true>: FUSED = true is K1
K1 = re.compile(r"dcn_gemm_(wgmma|f32)<\d+, true>")


def is_k1(name: str) -> bool:
    return K1.search(name) is not None


def read(trace, info):
    cfg = info["cfg"]
    if info["kind"] != "serve" or not cfg["dcn_sites"]:
        return None
    k1_us = trace.kernel_us(is_k1)
    if k1_us <= 0:
        return None
    b = info["batch"] * (2 if cfg["flip_test"] else 1)
    bound_ms = sum(s["calls"] * k1_bound(b, s["hw"], s["cin"], s["cout"],
                                         cfg["precision"])[0]
                   for s in cfg["dcn_sites"])
    return 100.0 * bound_ms * trace.items / (k1_us / 1e3)
