"""Process start to window open: weights, kernel build or load, warm-ups,
and the serving traffic's ramp."""


def read(run):
    return run.setup_s
