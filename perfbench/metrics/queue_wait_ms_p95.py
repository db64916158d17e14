"""Engine: p95 over the requests due in the window of the start of their
prefill (``Request.t_prefill``) - due time."""

from perfbench.harness.stats import p95


def read(run):
    return p95((r.t_prefill - r.due) * 1e3 for r in run.due_in_window() if r.t_prefill is not None)
