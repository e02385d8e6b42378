"""dcn_roofline.train: the DCN training kernels' share of their roofline
in a traced stretch of training steps: the sum over the configuration's
DCN sites of the least time a K2 forward call and a backward call can
take (``harness/roofline.train_bounds``: inputs read once, outputs
written once, products at the dense peak), over the device time of the
K2 kernels and the backward kernels found by name.  None where the
stretch ran none of them.  Moves ``train_img_s``."""

import re

from benchmark.harness.roofline import train_bounds

# dcn_gemm_wgmma<NT, false> / dcn_gemm_f32<NT, false> (FUSED = false: K2)
# and every kernel of the backward (dcn_bwd_*)
DCN_TRAIN = re.compile(r"dcn_gemm_(wgmma|f32)<\d+, false>|dcn_bwd_\w+")


def is_dcn_train(name: str) -> bool:
    return DCN_TRAIN.search(name) is not None


def read(trace, info):
    cfg = info["cfg"]
    if info["kind"] != "train" or not cfg["dcn_sites"]:
        return None
    us = trace.kernel_us(is_dcn_train)
    if us <= 0:
        return None
    bound_ms = sum(s["calls"] * sum(ms for ms, _ in train_bounds(
        info["batch"], s["hw"], s["cin"], s["cout"], cfg["precision"]))
        for s in cfg["dcn_sites"])
    return 100.0 * bound_ms * trace.items / (us / 1e3)
