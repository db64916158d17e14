"""The paper's contribution: SystolicAttention / FSA in PyTorch (counterpart
of ``repro.core``).

Modules:
  pwl_exp2       — K-segment piecewise-linear exp2 (paper §3.3, Fig. 12)
  attention      — Algorithm-1-faithful flash attention (exact or PWL exp2)
  systolic_model — cycle/utilization models reproducing Fig. 11
  fsa_sim        — instruction-level FSA device simulator (§4)
  fsa_kernel_api — NKI-style Python kernel programming model (§5)
  fsa_flash      — the paper's Listing 2 FlashAttention kernel
"""

from .attention import naive_attention, systolic_attention
from .pwl_exp2 import DEFAULT_SEGMENTS, pwl_error_stats, pwl_exp, pwl_exp2
from .systolic_model import (
    figure11,
    fsa_attention_cycles,
    fsa_tile_cycles,
    fsa_utilization,
)

__all__ = [
    "systolic_attention",
    "naive_attention",
    "pwl_exp2",
    "pwl_exp",
    "pwl_error_stats",
    "DEFAULT_SEGMENTS",
    "fsa_attention_cycles",
    "fsa_tile_cycles",
    "fsa_utilization",
    "figure11",
]
