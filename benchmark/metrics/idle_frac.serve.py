"""idle_frac.serve: the share of a traced serving stretch in which no
kernel or copy ran on the device (100 * (1 - busy / window)), where busy
is the union of the device events' intervals (``harness/trace.busy_us``).
Moves ``serve_img_s``."""


def read(trace, info):
    if info["kind"] != "serve":
        return None
    window = (trace.end_us - trace.start_us) / 1e6
    return 100.0 * (1.0 - trace.busy_s / window)
