"""mfu.train: the whole training step's share of the card's published dense
peak in the configuration's precision (``harness/roofline.PEAK_FLOPS``):
the configuration file's forward-plus-backward FLOPs per image times the
images stepped in the traced stretch, over its wall time.  Moves
``train_img_s``."""

from benchmark.harness.roofline import PEAK_FLOPS


def read(trace, info):
    if info["kind"] != "train":
        return None
    cfg = info["cfg"]
    images = trace.items * info["images_per_item"]
    window = (trace.end_us - trace.start_us) / 1e6
    return (100.0 * cfg["flops_train_per_image"] * images / window
            / PEAK_FLOPS[cfg["precision"]])
