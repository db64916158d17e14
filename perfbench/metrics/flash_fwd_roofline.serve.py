"""Attention kernels: the roofline bound of the sm90 forward launches of
the traced slice's prefills over their device time, in %.  A prefill
launches the kernel once per layer at its bucket's length; the bound counts
the true prompt's causal pairs and bytes, so bucket padding reads as lost
share."""

from perfbench.harness import costs, profiling
from perfbench.harness.stats import spans

KERNEL = "flash_fwd_sm90_kernel"


def read(run):
    if run.trace is None:
        return None
    device_s, launches = profiling.kernel_seconds(run.trace, KERNEL)
    m = run.model
    lengths = [s[3]["len"] for s in spans(run, "prefill", where="trace")]
    if not launches or not lengths:
        return None
    bound = sum(costs.bound_seconds(*costs.attention_fwd_cost(1, n, m["num_heads"], m["head_dim"], 2,
                                                              m["num_kv_heads"])) for n in lengths)
    return 100.0 * bound * m["num_layers"] / device_s
