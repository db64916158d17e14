"""Model step: the engine's ``generate`` spans of the window (one batched
decode step each), total over count."""

from perfbench.harness.stats import spans


def read(run):
    found = spans(run, "generate")
    if not found:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / len(found)
