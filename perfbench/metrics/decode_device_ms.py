"""Model step: the program's ``decode_step`` device spans of the window
(the batched decode step from its first kernel to its last, on the
device's clock), total over count.  Its gap to ``decode_step_ms`` is the
host's part of the step outside the device's run."""

from perfbench.harness.stats import spans


def read(run):
    found = spans(run, "decode_step")
    if not found:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / len(found)
