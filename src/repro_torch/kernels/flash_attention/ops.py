"""Public entry point for the fused flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``), forward only in this slice.

The reference's ``impl`` and ``interpret`` select between its Pallas kernel
and its scan-based jnp path; here the device of the inputs selects: the CUDA
kernel on the card, the plain tiled Algorithm 1 on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, flash_attention_fwd


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    exp2_impl: str = "exact",
    num_segments: int = 8,
) -> torch.Tensor:
    """Fused attention, [B,S,H,d] layout, GQA-aware.  Forward only on the
    card: the dq/dkv kernels and the ``torch.autograd.Function`` around them
    come with the training slice."""
    if q.is_cuda and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        raise NotImplementedError(
            "flash_attention has no backward kernels on the card yet "
            "(ROADMAP queue 1, the training slice); run under "
            "torch.no_grad() or use attention_impl='naive'"
        )
    return flash_attention_fwd(
        q, k, v,
        causal=causal, scale=scale, q_offset=q_offset,
        block_q=block_q, block_k=block_k,
        exp2_impl=exp2_impl, num_segments=num_segments,
    )
