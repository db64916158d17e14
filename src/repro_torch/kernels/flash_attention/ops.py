"""Public entry point for the fused flash-attention kernels (counterpart of
``repro.kernels.flash_attention.ops``).

The reference's ``impl`` and ``interpret`` select between its Pallas kernels
and its scan-based jnp path; here the device of the inputs selects: the CUDA
kernels on the card, their plain versions on the CPU. Either way the
gradient is the reference's ``"pallas"`` one: the FlashAttention-2 backward
with the exact exp2, also after a PWL forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, flash_attention_fwd
from .kernel_bwd import flash_attention_bwd


class _FlashAttention(torch.autograd.Function):
    """The forward saves (q, k, v, o, LSE); the backward recomputes P from
    the LSE in the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, block_q, block_k, exp2_impl, num_segments):
        out, lse = flash_attention_fwd(
            q, k, v,
            causal=causal, scale=scale, q_offset=q_offset,
            block_q=block_q, block_k=block_k,
            exp2_impl=exp2_impl, num_segments=num_segments, return_lse=True,
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


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
    """Fused attention, [B,S,H,d] layout, GQA-aware.  Differentiable; with
    no gradient to take, the forward runs alone and keeps no LSE."""
    args = (causal, scale, q_offset, block_q, block_k, exp2_impl, num_segments)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, *args)
    return flash_attention_fwd(
        q, k, v,
        causal=causal, scale=scale, q_offset=q_offset,
        block_q=block_q, block_k=block_k,
        exp2_impl=exp2_impl, num_segments=num_segments,
    )
