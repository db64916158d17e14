"""Whole step: model FLOPs of the window's training steps (no remat
recompute) over the window's length and the card's bf16 peak, in %."""

from perfbench.harness import costs


def read(run):
    tr = run.traffic
    flops = len(run.steps) * costs.train_step_flops(run.model, tr["batch"], tr["seq_len"])
    return costs.mfu(flops, run.window_s)
