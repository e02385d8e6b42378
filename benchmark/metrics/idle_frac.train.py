"""idle_frac.train: the share of a traced stretch of training steps in
which no kernel or copy ran on the device (100 * (1 - busy / window)),
busy the union of the device events' intervals.  Moves ``train_img_s``."""


def read(trace, info):
    if info["kind"] != "train":
        return None
    window = (trace.end_us - trace.start_us) / 1e6
    return 100.0 * (1.0 - trace.busy_s / window)
