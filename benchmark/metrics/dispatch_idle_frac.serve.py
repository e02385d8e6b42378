"""dispatch_idle_frac.serve: the share of a traced serving stretch in
which the device was idle while the host was inside the serving step (the
union of the port's ``serve.model`` and ``serve.decode`` spans): the
device waiting on the host's dispatch of the forward and the decode.
Part of ``idle_frac.serve``.  None without the spans.  Moves
``serve_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "serve":
        return None
    inside = spans.union(trace, ("serve.model", "serve.decode"))
    if not inside:
        return None
    return (100.0 * spans.overlap_us(spans.idle(trace), inside)
            / spans.stretch_us(trace))
