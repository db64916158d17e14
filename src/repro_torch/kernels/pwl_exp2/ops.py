"""The PWL exp2 entry point (counterpart of ``repro.kernels.pwl_exp2.ops``):
the CUDA kernel for a tensor on the card, its plain version for a tensor on
the CPU."""

from __future__ import annotations

import torch

from .kernel import pwl_exp2_cuda


def pwl_exp2(x: torch.Tensor, *, num_segments: int = 8) -> torch.Tensor:
    """PWL exp2 over a tensor of any shape (x <= 0), in x's dtype."""
    return pwl_exp2_cuda(x, num_segments=num_segments)
