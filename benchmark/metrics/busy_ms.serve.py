"""busy_ms.serve: the device's busy time per served batch over a traced
stretch (the union of the device events' intervals over the batches
served in it).  Moves ``serve_img_s``."""


def read(trace, info):
    if info["kind"] != "serve":
        return None
    return trace.busy_s * 1e3 / trace.items
