"""Tokens of every training step of the window, over the window (which
closes at the end of its last step)."""


def read(run):
    return sum(s.tokens for s in run.steps) / run.window_s
