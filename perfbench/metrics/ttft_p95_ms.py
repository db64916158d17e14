"""p95 over the requests due in the window of first token time - due time."""

from perfbench.harness.stats import p95


def read(run):
    v = p95((r.token_times[0] - r.due) * 1e3 for r in run.due_in_window() if r.token_times)
    return v
