"""Device: the share of the traced slice with nothing running on the
device (no kernel, copy or memset), in %."""


def read(run):
    t = run.trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
