"""busy_ms.train: the device's busy time per training step over a traced
stretch (the union of the device events' intervals over its steps).
Moves ``train_img_s``."""


def read(trace, info):
    if info["kind"] != "train":
        return None
    return trace.busy_s * 1e3 / trace.items
