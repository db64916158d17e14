"""Optimizer: the program's ``optimizer`` device spans (AdamW's update and
the gradient norm, one a step) of the window, summed, over the window's
``train_step`` spans: the optimizer's device time a step."""

from perfbench.harness.stats import spans


def read(run):
    steps, found = spans(run, "train_step"), spans(run, "optimizer")
    if not steps or not found:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / len(steps)
