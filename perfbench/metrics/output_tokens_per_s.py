"""Output tokens emitted in the window (first tokens included), over the
window's length."""


def read(run):
    n = sum(1 for r in run.requests for t in r.token_times if run.in_window(t))
    return n / run.window_s
