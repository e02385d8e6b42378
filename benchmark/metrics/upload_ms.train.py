"""upload_ms.train: the host's time per training step in the step's
upload (the port's ``train.upload`` span in ``Trainer._loss``:
``batch_to_device`` and ``unpack_batch``), summed over a traced stretch.
None without the span.  Moves ``train_img_s``."""

from benchmark.harness import spans


def read(trace, info):
    if info["kind"] != "train":
        return None
    us = spans.durations(trace, "train.upload")
    if not us:
        return None
    return sum(us) / 1e3 / trace.items
