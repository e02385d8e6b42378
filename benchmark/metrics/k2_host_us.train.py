"""k2_host_us.train: the host's mean time per call of K2, the operator
``centerpose::dcn_v2`` (the dispatcher's event around each call in the
training forward, autograd's bookkeeping, its Python implementation and
launch included), in a traced stretch of training steps.  None where the
stretch called no K2.  Moves ``train_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "train":
        return None
    us = spans.durations(trace, "centerpose::dcn_v2")
    if not us:
        return None
    return sum(us) / len(us)
