"""mfu.serve: the whole serving step's share of the card's published dense
peak in the configuration's precision (``harness/roofline.PEAK_FLOPS``):
the configuration file's forward FLOPs per image (twice that with the
flip test) times the images served in the traced stretch, over its wall
time.  The FLOPs are counted once from the shapes, so the number reads the
same work whatever implements it.  Moves ``serve_img_s``."""

from benchmark.harness.roofline import PEAK_FLOPS


def read(trace, info):
    if info["kind"] != "serve":
        return None
    cfg = info["cfg"]
    flops = cfg["flops_fwd_per_image"] * (2 if cfg["flip_test"] else 1)
    images = trace.items * info["images_per_item"]
    window = (trace.end_us - trace.start_us) / 1e6
    return 100.0 * flops * images / window / PEAK_FLOPS[cfg["precision"]]
