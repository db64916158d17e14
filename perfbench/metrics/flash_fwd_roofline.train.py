"""Attention kernels: the roofline bound of training's sm90 forward
launches in the traced slice (each counted, remat's recompute too) over
their device time, in %."""

from perfbench.harness import costs, profiling

KERNEL = "flash_fwd_sm90_kernel"


def read(run):
    if run.trace is None:
        return None
    device_s, launches = profiling.kernel_seconds(run.trace, KERNEL)
    if not launches:
        return None
    m, tr = run.model, run.traffic
    one = costs.bound_seconds(*costs.attention_fwd_cost(tr["batch"], tr["seq_len"], m["num_heads"],
                                                        m["head_dim"], 2, m["num_kv_heads"]))
    return 100.0 * one * launches / device_s
