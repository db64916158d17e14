"""Whole step: model FLOPs of the window's work (each prefill that started
in it over its true prompt, each decoded token at its context) over the
window's length and the card's bf16 peak, in %."""

from perfbench.harness import costs


def read(run):
    m, flops = run.model, 0.0
    for r in run.requests:
        if r.t_prefill is not None and run.in_window(r.t_prefill):
            flops += costs.prefill_flops(m, r.prompt_len)
        for j, t in enumerate(r.token_times[1:], start=1):
            if run.in_window(t):
                flops += costs.decode_token_flops(m, r.prompt_len + j - 1)
    return costs.mfu(flops, run.window_s)
