"""Attention kernels: the roofline bound of the five products FA-2's
backward needs (S, dP, dV, dK, dQ) over the device time of the sm90 dQ and
dK/dV kernels together, per launched pair in the traced slice, in %."""

from perfbench.harness import costs, profiling


def read(run):
    if run.trace is None:
        return None
    dq_s, pairs = profiling.kernel_seconds(run.trace, "flash_bwd_sm90_dq_kernel")
    dkv_s, _ = profiling.kernel_seconds(run.trace, "flash_bwd_sm90_dkv_kernel")
    if not pairs:
        return None
    m, tr = run.model, run.traffic
    one = costs.bound_seconds(*costs.attention_bwd_cost(tr["batch"], tr["seq_len"], m["num_heads"],
                                                        m["num_kv_heads"], m["head_dim"], 2))
    return 100.0 * one * pairs / (dq_s + dkv_s)
