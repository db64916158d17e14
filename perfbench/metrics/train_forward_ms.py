"""Model step: the program's ``forward`` device spans (``lm_loss`` under
autograd, one a microbatch) of the window, summed, over the window's
``train_step`` spans: the forward's device time a step."""

from perfbench.harness.stats import spans


def read(run):
    steps, found = spans(run, "train_step"), spans(run, "forward")
    if not steps or not found:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / len(steps)
