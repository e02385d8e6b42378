"""upload_ms.serve: the host's time per served batch in the serving
entry's upload (the port's ``serve.upload`` span in
``Detector.run_batch``: the frames' ``from_numpy`` and pageable
host-to-device copy), summed over a traced stretch.  None without the
span.  Moves ``serve_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "serve":
        return None
    us = spans.durations(trace, "serve.upload")
    if not us:
        return None
    return sum(us) / 1e3 / trace.items
