"""dispatch_idle_frac.train: the share of a traced stretch of training
steps in which the device was idle while the host was inside the step's
forward, backward or optimizer (the union of the port's
``train.forward``, ``train.backward`` and ``train.optimizer`` spans): the
device waiting on the host's dispatch.  Part of ``idle_frac.train``.
None without the spans.  Moves ``train_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "train":
        return None
    inside = spans.union(trace, ("train.forward", "train.backward",
                                 "train.optimizer"))
    if not inside:
        return None
    return (100.0 * spans.overlap_us(spans.idle(trace), inside)
            / spans.stretch_us(trace))
