"""SystolicAttention — the paper's Algorithm 1 in plain PyTorch
(counterpart of ``repro.core.attention``).

``systolic_attention`` keeps the reference's operation order: rowmax on the
unscaled scores, ``log2(e)/sqrt(d)`` folded into the exp2 argument (exact or
the §3.3 PWL), fp32 state whatever the input dtype, and a final division by
``l`` with ``l == 0`` guarded.  It is the plain version of the CUDA kernel in
``repro_torch.kernels.flash_attention`` (which runs it for a tensor on the
CPU) and the oracle the kernel is held against on the card.
``naive_attention`` materialises the softmax.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .pwl_exp2 import DEFAULT_SEGMENTS, LOG2_E, pwl_exp2

__all__ = ["systolic_attention", "naive_attention"]

NEG_INF = -1e30  # finite stand-in for -inf: -inf - (-inf) would be NaN


def _exp2_fn(impl: str, num_segments: int) -> Callable[[torch.Tensor], torch.Tensor]:
    if impl == "exact":
        return torch.exp2
    if impl == "pwl":
        return functools.partial(pwl_exp2, num_segments=num_segments)
    raise ValueError(f"unknown exp2 impl: {impl!r} (want 'exact' or 'pwl')")


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim -2 (the sequence of a [..., S, d] tensor) by ``pad``."""
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def algorithm1(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, dv]
    *,
    causal: bool,
    block_q: int,
    block_k: int,
    exp2: Callable,
    scale: float,
    q_offset: int = 0,
    bias: Optional[torch.Tensor] = None,  # [Sq, Sk]
    p_dtype: Optional[torch.dtype] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tiled Algorithm 1 over all batches and heads at once.

    Returns the normalised output ``[B, H, Sq, dv]`` in fp32, the running
    max ``m`` (unscaled) and the guarded row sum ``l``, both ``[B, H, Sq]``.
    GQA folds a kv-head's ``rep`` query heads into the rows of one product,
    so K/V are never repeated.  With ``p_dtype`` P is rounded to it for the
    PV product only, as a tensor-core kernel takes it; ``l`` is summed from
    the fp32 P either way.
    """
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    assert h % hkv == 0, (h, hkv)
    rep = h // hkv
    c = scale * LOG2_E  # log2(e)/sqrt(d): folded into the exp2 argument
    bq, bk = min(block_q, sq), min(block_k, sk)
    n_q, n_k = -(-sq // bq), -(-sk // bk)
    pad_q, pad_k = n_q * bq - sq, n_k * bk - sk
    dev = q.device

    q32 = _pad_seq(q.float().permute(0, 2, 1, 3), pad_q).reshape(b, hkv, rep, -1, d)
    k32 = _pad_seq(k.float().permute(0, 2, 1, 3), pad_k)  # [B, Hkv, Sk', d]
    v32 = _pad_seq(v.float().permute(0, 2, 1, 3), pad_k)
    if bias is not None:
        bias = F.pad(bias.float(), (0, pad_k, 0, pad_q))

    outs, ms, ls = [], [], []
    for i in range(n_q):
        q_i = q32[:, :, :, i * bq:(i + 1) * bq].reshape(b, hkv, rep * bq, d)
        m = torch.full((b, hkv, rep * bq), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, rep * bq), device=dev)
        acc = torch.zeros((b, hkv, rep * bq, dv), device=dev)
        rows = i * bq + q_offset + torch.arange(bq, device=dev)[:, None]
        for j in range(n_k):
            k_j = k32[:, :, j * bk:(j + 1) * bk]
            v_j = v32[:, :, j * bk:(j + 1) * bk]
            # line 6: S = Q_i K_j^T (unscaled, as in Algorithm 1)
            s = (q_i @ k_j.transpose(-1, -2)).view(b, hkv, rep, bq, bk)
            if bias is not None:
                s = s + bias[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk] / scale
            cols = j * bk + torch.arange(bk, device=dev)[None, :]
            if pad_k:
                s = s + torch.where(cols < sk, 0.0, NEG_INF)
            if causal:
                s = s + torch.where(rows >= cols, 0.0, NEG_INF)
            s = s.view(b, hkv, rep * bq, bk)
            # lines 7-16
            new_m = torch.maximum(s.amax(dim=-1), m)
            b_corr = exp2(c * (m - new_m))
            p = exp2(c * (s - new_m[..., None]))
            l = l * b_corr + p.sum(dim=-1)
            if p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = b_corr[..., None] * acc + p @ v_j
            m = new_m
        # line 21: O_i = diag(l)^-1 O   (guard fully-masked rows)
        safe_l = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / safe_l[..., None]).view(b, hkv, rep, bq, dv))
        ms.append(m.view(b, hkv, rep, bq))
        ls.append(safe_l.view(b, hkv, rep, bq))
    o = torch.cat(outs, dim=3)[:, :, :, :sq].reshape(b, h, sq, dv)
    m = torch.cat(ms, dim=3)[:, :, :, :sq].reshape(b, h, sq)
    l = torch.cat(ls, dim=3)[:, :, :, :sq].reshape(b, h, sq)
    return o, m, l


def systolic_attention(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, dv]
    *,
    causal: bool = False,
    block_q: int = 128,
    block_k: int = 128,
    exp2_impl: str = "exact",
    num_segments: int = DEFAULT_SEGMENTS,
    scale: Optional[float] = None,
    q_offset: int = 0,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched multi-head SystolicAttention (GQA-aware), output in q's dtype.

    ``q_offset`` is the absolute position of ``q[:, 0]`` (chunked prefill
    against a longer KV); ``bias`` is an additive ``[Sq, Sk]`` bias.  The
    reference's ``unroll`` is a dry-run knob of ``jax.lax.scan`` and has no
    counterpart here.
    """
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    o, _, _ = algorithm1(
        q, k, v,
        causal=causal, block_q=block_q, block_k=block_k,
        exp2=_exp2_fn(exp2_impl, num_segments), scale=scale,
        q_offset=q_offset, bias=bias,
    )
    return o.permute(0, 2, 1, 3).to(q.dtype)


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    bias: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Materialised-softmax oracle; GQA by kv-head repetition."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype), kr.to(dtype)) * scale
    if bias is not None:
        s = s + bias.to(dtype)
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(dtype))
    return o.to(q.dtype)
