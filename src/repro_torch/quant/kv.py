"""int8 KV-cache storage: per-token/per-head symmetric scales (counterpart
of ``repro.quant.kv``).

Each cached K (or V) vector — one (slot, position, kv_head) row of
``head_dim`` values — gets its own fp32 scale, so a token's quantized K/V
is independent of everything else in the cache: chunked flash prefill and
the decode scatter-write store byte-identical rows for the same token.

At rest the cache is ``head_dim`` int8 + 4 scale bytes per row, against
``2 * head_dim`` bytes in bf16 (about 1.9x smaller at d = 128).
"""

from __future__ import annotations

import torch

from .quantize import _round_clip, _scale


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., d] -> (int8 [..., d], fp32 scale [...]): one scale per vector."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1))
    return _round_clip(xf, scale[..., None]), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 payload x per-vector scale."""
    return (q.float() * scale[..., None]).to(dtype)
