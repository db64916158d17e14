"""Model step: the program's ``backward`` device spans
(``torch.autograd.grad``, remat's recomputed forward included, one a
microbatch) of the window, summed, over the window's ``train_step`` spans:
the backward's device time a step."""

from perfbench.harness.stats import spans


def read(run):
    steps, found = spans(run, "train_step"), spans(run, "backward")
    if not steps or not found:
        return None
    return sum(s[2] - s[1] for s in found) * 1e3 / len(steps)
