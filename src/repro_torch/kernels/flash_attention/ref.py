"""Plain oracle for the flash-attention kernels (counterpart of
``repro.kernels.flash_attention.ref``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def attention_reference(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, d]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialized-softmax attention in fp32; GQA by kv-head repetition."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return o.to(q.dtype)
