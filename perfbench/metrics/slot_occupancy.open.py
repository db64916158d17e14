"""Engine, in an open loop below the knee: live slots / batch size at each
generate step of the window (the engine's ``generate`` spans carry the live
count), in %.  There the arrivals are fixed, so by Little's law the
occupancy is the rate times each request's time in a slot over the slots:
it falls as the steps get shorter, and moves ``itl_p95_ms``."""

from perfbench.harness.stats import spans


def read(run):
    live = [s[3]["live"] for s in spans(run, "generate")]
    if not live:
        return None
    return 100.0 * sum(live) / (len(live) * run.traffic["engine"]["batch_size"])
