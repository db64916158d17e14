"""p95 over all gaps between successive output tokens of all requests, for
the gaps that end in the window."""

from perfbench.harness.stats import p95


def read(run):
    return p95((b - a) * 1e3 for r in run.requests for a, b in zip(r.token_times, r.token_times[1:])
               if run.in_window(b))
