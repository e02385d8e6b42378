"""dispatch_ms.serve: the host's time per served batch in the serving
step (the port's ``serve.model`` and ``serve.decode`` spans in
``ServingNet.forward``: normalisation, flip, the model's operators, the
sigmoids and the decode, as the host issues them), summed over a traced
stretch.  None without the spans.  Moves ``serve_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "serve":
        return None
    us = (spans.durations(trace, "serve.model")
          + spans.durations(trace, "serve.decode"))
    if not us:
        return None
    return sum(us) / 1e3 / trace.items
