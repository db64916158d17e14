"""Model step: the engine's ``prefill`` spans of the window, summed, per
1000 true prompt tokens (padding to the bucket is the program's cost)."""

from perfbench.harness.stats import spans


def read(run):
    found = spans(run, "prefill")
    tokens = sum(s[3]["len"] for s in found)
    if not tokens:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / (tokens / 1000.0)
