"""k1_host_us.serve: the host's mean time per call of K1, the operator
``centerpose::dcn_v2_fused`` (the dispatcher's event around each call,
its Python implementation and launch included), in a traced serving
stretch.  None where the stretch called no K1.  Moves ``serve_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "serve":
        return None
    us = spans.durations(trace, "centerpose::dcn_v2_fused")
    if not us:
        return None
    return sum(us) / len(us)
