"""outside_idle_frac.serve: the share of a traced serving stretch in
which the device was idle while the host was outside every call of the
serving entry (the port's ``serve.batch`` span around
``Detector.run_batch``): the caller between batches.  Part of
``idle_frac.serve``; the rest of it lies inside ``serve.batch`` but
outside the serving step (the upload and the read-back).  None without
the span.  Moves ``serve_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "serve":
        return None
    batches = spans.union(trace, ("serve.batch",))
    if not batches:
        return None
    idle = spans.idle(trace)
    outside = spans.length_us(idle) - spans.overlap_us(idle, batches)
    return 100.0 * outside / spans.stretch_us(trace)
