"""GQA attention layer: params, forward (train/prefill), decode with KV cache
(counterpart of ``repro.models.attention``).

``cfg.attention_impl`` selects

  * ``systolic`` or ``pallas`` — ``flash_attention``: the hand-written CUDA
    kernels for tensors on the card, their plain versions for tensors on
    the CPU (the forward computes the reference's ``systolic`` and
    ``pallas``; the gradient is its ``pallas`` one, exact-exp2 FA-2, for
    both: ROADMAP queue 3, departure (a));
  * ``naive`` — materialised softmax (the oracle).

Per the paper §8.3, decode (one query token, memory-bound) never uses the
FSA path: ``decode_attention`` and ``verify_attention`` attend through
``kernels.decode_attention`` (the reference's grouped matmul and fp32
softmax over the cache: the hand-written split-row kernel on the card,
which reads only the rows each query sees, and the reference's masked
einsums on the CPU).

The KV cache is updated in place: ``prefill_attention`` writes the chunk's
rows, ``decode_attention`` scatters one row per slot and
``verify_attention`` (speculative decoding) S rows per slot into the tensors
of the cache it is given (the reference returns updated copies).  Under a quant
policy with ``kv_cache`` the cache is a ``QuantKVCache``: K and V are
quantized on write (one scale per token and kv head), prefill attends over
the dequantized span in x's dtype and decode over the dequantized cache in
fp32, as in the reference (through ``kernels.decode_attention`` too).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import naive_attention
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.obs import get_tracer
from repro_torch.quant import dequantize_kv, get_quant, quantize_kv
from .layers import apply_mrope, apply_rope, dense_init, rms_norm
from .parallel import attention as _sharded, is_dtensor


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, max_len, Hkv, d]
    v: torch.Tensor  # [B, max_len, Hkv, d]
    lengths: torch.Tensor  # [B] int32: tokens cached per batch slot


class QuantKVCache(NamedTuple):
    """int8 KV storage: payloads + per-token/head fp32 scales.  As in the
    reference, ``lengths`` is last and batch is dim 0 of every leaf."""

    k: torch.Tensor  # int8 [B, max_len, Hkv, d]
    v: torch.Tensor  # int8 [B, max_len, Hkv, d]
    k_scale: torch.Tensor  # fp32 [B, max_len, Hkv]
    v_scale: torch.Tensor  # fp32 [B, max_len, Hkv]
    lengths: torch.Tensor  # [B] int32: tokens cached per batch slot


def attention_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:  # qwen3-style per-head q/k RMSNorm
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(x, params, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    quant = get_quant(cfg)
    q = quant.dot(x, params["wq"], "attention")
    k = quant.dot(x, params["wk"], "attention")
    v = quant.dot(x, params["wv"], "attention")
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _impl_attention(q, k, v, cfg: ModelConfig, q_offset: int = 0) -> torch.Tensor:
    """Dispatch full-sequence attention to the configured implementation.

    Shared by the full-sequence forward and the chunked prefill, so both
    give the same numerics for the same (q, k, v).
    """
    if cfg.attention_impl == "naive":
        return naive_attention(q, k, v, causal=cfg.causal, q_offset=q_offset)
    if cfg.attention_impl in ("systolic", "pallas"):
        return flash_attention(
            q, k, v, cfg.causal, None, q_offset,
            cfg.attn_block_q, cfg.attn_block_k, cfg.exp2_impl, 8,
        )
    raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


def attention_forward(
    x: torch.Tensor,  # [B, S, d_model]
    params: dict,
    cfg: ModelConfig,
    positions: torch.Tensor,  # [B, S] (or [B, S, 3] for M-RoPE)
) -> torch.Tensor:
    """Full-sequence attention (training / prefill)."""
    if is_dtensor(x):
        return _sharded(lambda x, p, c, pos, _kv, _wp: attention_forward(x, p, c, pos), x, params, cfg, positions)
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, params, cfg, positions)
    o = _impl_attention(q, k, v, cfg)
    o = o.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return get_quant(cfg).dot(o, params["wo"], "attention")


def prefill_attention(
    x: torch.Tensor,  # [B, C, d_model] — one prefill chunk
    params: dict,
    cfg: ModelConfig,
    cache: KVCache,  # seq capacity >= start + C; updated in place
    positions: torch.Tensor,  # [B, C] (or [B, C, 3]) absolute positions
    start: int,  # chunk offset: tokens [0, start) are already cached
) -> tuple[torch.Tensor, KVCache]:
    """Chunked flash prefill: write the chunk's K/V into the cache and attend
    the chunk's queries over everything cached so far, with causality
    against the earlier chunks from ``q_offset=start``.  ``cache.lengths``
    is left for the caller to set once the whole prompt is in."""
    if is_dtensor(x):
        o = _sharded(lambda x, p, c, pos, kv, _wp: prefill_attention(x, p, c, kv, pos, start)[0],
                     x, params, cfg, positions, cache)
        return o, cache
    b, c, _ = x.shape
    capacity = cache.k.shape[1]
    # The reference's dynamic_update_slice would clamp the start and
    # overwrite earlier rows; no caller asks for that, so refuse it.
    if start < 0 or start + c > capacity:
        raise ValueError(f"chunk [{start}, {start + c}) exceeds cache capacity {capacity}")
    q, k_new, v_new = _project_qkv(x, params, cfg, positions)
    span = slice(start, start + c)
    if isinstance(cache, QuantKVCache):
        # Quantize on insert: each token/head vector gets its own scale, so
        # the chunk write equals what decode's row writes would store.
        cache.k[:, span], cache.k_scale[:, span] = quantize_kv(k_new)
        cache.v[:, span], cache.v_scale[:, span] = quantize_kv(v_new)
        k = dequantize_kv(cache.k[:, :start + c], cache.k_scale[:, :start + c], x.dtype)
        v = dequantize_kv(cache.v[:, :start + c], cache.v_scale[:, :start + c], x.dtype)
    else:
        cache.k[:, span] = k_new
        cache.v[:, span] = v_new
        k, v = cache.k[:, :start + c], cache.v[:, :start + c]
    o = _impl_attention(q, k, v, cfg, q_offset=start)
    o = o.reshape(b, c, cfg.num_heads * cfg.resolved_head_dim)
    return get_quant(cfg).dot(o, params["wo"], "attention"), cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if get_quant(cfg).quantized_kv:
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            lengths=lengths,
        )
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=lengths,
    )


def decode_attention(
    x: torch.Tensor,  # [B, 1, d_model]
    params: dict,
    cfg: ModelConfig,
    cache: KVCache,  # updated in place
    positions: torch.Tensor,  # [B, 1] (or [B, 1, 3])
) -> tuple[torch.Tensor, KVCache]:
    """Single-token decode against the KV cache (paper §8.3: never FSA).

    Slot i's new K/V goes to row ``lengths[i]``, so slots at different
    depths share one step.  A slot whose length has reached capacity writes
    nothing, like the reference's ``mode="drop"`` scatter.  It is the
    verify pass at S = 1 with the write rows at the cached lengths.  The
    whole layer is one device span, ``decode_attention``, on the ambient
    tracer.
    """
    with get_tracer().span("decode_attention", device=True):
        o, cache = verify_attention(x, params, cfg, cache, positions, cache.lengths)
    return o, cache._replace(lengths=cache.lengths + 1)


def verify_attention(
    x: torch.Tensor,  # [B, S, d_model]: S teacher-forced tokens per slot
    params: dict,
    cfg: ModelConfig,
    cache: KVCache,  # updated in place
    positions: torch.Tensor,  # [B, S] (or [B, S, 3]) absolute positions
    write_pos: torch.Tensor,  # [B] int: first write row per slot
) -> tuple[torch.Tensor, KVCache]:
    """Speculative-verify attention: S tokens per slot scored in one pass
    against the live decode cache.

    Slot i's rows go to ``write_pos[i] + j`` and query j sees keys at
    positions ``<= write_pos[i] + j``: row j sees exactly the cache a
    sequential ``decode_attention`` step would have seen.  Under an int8 KV
    policy the rows are quantized on write (one scale per token and kv
    head), so accepted rows hold what sequential decode writes for the same
    K/V.  ``cache.lengths`` is left for the caller's rollback.

    Rows at or past capacity are dropped, like the reference's
    ``mode="drop"`` scatter, without a host sync: such a row r is sent to
    row ``r % max_len``, which lies before ``write_pos[i]`` when
    S <= max_len, and rewrites the value held there.  The indices of a slot
    stay distinct, so no dropped row can land on a valid write (a clamp to
    ``max_len - 1`` would put several rows on one index).
    """
    if is_dtensor(x):
        o = _sharded(lambda x, p, c, pos, kv, wp: verify_attention(x, p, c, kv, pos, wp)[0],
                     x, params, cfg, positions, cache, write_pos)
        return o, cache
    b, s_new, _ = x.shape
    hd = cfg.resolved_head_dim
    max_len = cache.k.shape[1]
    if s_new > max_len:
        raise ValueError(f"{s_new} verify rows exceed cache capacity {max_len}")
    q, k_new, v_new = _project_qkv(x, params, cfg, positions)

    slot = torch.arange(b, device=x.device)[:, None]  # [B, 1]
    rows = write_pos.to(torch.long)[:, None] + torch.arange(s_new, device=x.device)[None, :]  # [B, S]
    dropped = rows >= max_len
    target = torch.where(dropped, rows % max_len, rows)
    if isinstance(cache, QuantKVCache):
        (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
        new_rows = dict(k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        new_rows = dict(k=k_new, v=v_new)
    for name, new in new_rows.items():
        leaf = getattr(cache, name)
        keep = dropped.reshape(b, s_new, *[1] * (new.dim() - 2))
        leaf[slot, target] = torch.where(keep, leaf[slot, target], new.to(leaf.dtype))
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))  # fp32, as the reference
    k, v = cache.k, cache.v
    if isinstance(cache, QuantKVCache):
        # The reference's fp32 dequantize; q widened to match (as the plain
        # version widens it anyway).
        k, v, q = dequantize_kv(k, cache.k_scale), dequantize_kv(v, cache.v_scale), q.float()
    o = decode_attention_fwd(q, k, v, write_pos, scale)
    o = o.to(x.dtype).reshape(b, s_new, cfg.num_heads * hd)
    return get_quant(cfg).dot(o, params["wo"], "attention"), cache
