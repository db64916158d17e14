"""Model assembly: init / forward / loss / prefill / decode (counterpart of
``repro.models.model``), for the dense, moe and vlm families, and the
encoder family in ``forward`` and ``lm_loss`` (it has no cache).

Params are plain nested dicts with the reference's keys; layer params are
stacked along a leading ``[L, ...]`` axis, and the layer ``scan`` becomes a
Python loop over layer slices (with ``cfg.remat``, each layer is a
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).  The
caches are stacked the same way (``KVCache`` leaves ``[L, B, ...]``,
``lengths [L, B]``; ``QuantKVCache`` leaves under an int8 KV policy) and
updated in place by prefill, decode and the speculative ``verify_step``.
MoE layers route with capacity in ``forward``, ``lm_loss`` and prefill, and
dropless in ``decode_step`` and ``verify_step``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import get_quant
from .attention import (
    KVCache,
    QuantKVCache,
    attention_forward,
    attention_params,
    decode_attention,
    init_kv_cache,
    prefill_attention,
    verify_attention,
)
from .layers import apply_norm, embed_init, mlp_forward, mlp_params, norm_params
from .moe import moe_forward, moe_params

_FAMILIES = ("dense", "moe", "vlm")  # every path, caches included
_FORWARD_FAMILIES = _FAMILIES + ("encoder",)  # init, forward, lm_loss
_LATER = {
    "hybrid": "ROADMAP queue 1, recurrent families",
    "ssm": "ROADMAP queue 1, recurrent families",
}


def _check_family(cfg: ModelConfig, families=_FAMILIES) -> None:
    if cfg.family == "encoder" and cfg.family not in families:
        raise ValueError("encoder archs have no decode cache")
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {_LATER.get(cfg.family, cfg.family)}"
        )


def _unstack(stacked: Any, n: int) -> list:
    """The ``n`` per-layer dicts (views) of a stacked params dict, by
    ``unbind``: its gradient is one stack of the layers' gradients, where
    indexing each layer would add a zero-filled ``[L, ...]`` buffer per
    layer.  ``None`` leaves stay ``None``."""
    if isinstance(stacked, dict):
        per_leaf = {name: _unstack(leaf, n) for name, leaf in stacked.items()}
        return [{name: leaves[i] for name, leaves in per_leaf.items()} for i in range(n)]
    return [None] * n if stacked is None else list(torch.unbind(stacked))


def _stack(layers: list) -> Any:
    """Inverse of ``_unstack``: stack per-layer dicts along a new axis 0."""
    first = layers[0]
    if isinstance(first, dict):
        return {name: _stack([p[name] for p in layers]) for name in first}
    return None if first is None else torch.stack(layers)


def _kv(cache, i: int):
    """Layer ``i``'s cache (views) of a stacked ``KVCache`` or ``QuantKVCache``."""
    return type(cache)(*(leaf[i] for leaf in cache))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _transformer_layer_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    p = {
        "attn_norm": norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
        "attn": attention_params(gen, cfg, dtype),
        "mlp_norm": norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
    }
    if cfg.moe is not None:
        p["moe"] = moe_params(gen, cfg, dtype)
        if cfg.moe.dense_residual:
            p["dense_mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    else:
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    _check_family(cfg, _FORWARD_FAMILIES)
    dtype = cfg.activation_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {}
    params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    params["final_norm"] = norm_params(cfg.d_model, cfg.norm_type, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).T.contiguous()
    params["layers"] = _stack(
        [_transformer_layer_params(gen, cfg, dtype) for _ in range(cfg.num_layers)]
    )
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _default_positions(cfg: ModelConfig, batch: int, seq: int, device, offset: int = 0):
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(batch, seq, 3)
    return pos


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(x, params: dict, cfg: ModelConfig, softcap: bool = True) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = x @ _head(params, cfg)
    if softcap and cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _mlp(h, layer, cfg: ModelConfig, dropless: bool = False):
    """The residual MLP (MoE, with arctic's dense FFN beside it) of a block;
    ``dropless`` routes MoE layers without capacity (decode)."""
    hn = apply_norm(h, layer["mlp_norm"], cfg.norm_type)
    quant = get_quant(cfg)
    if cfg.moe is None:
        return h + mlp_forward(hn, layer["mlp"], cfg.mlp_type, quant)
    y = moe_forward(hn, layer["moe"], cfg, dropless=dropless)
    if cfg.moe.dense_residual:
        y = y + mlp_forward(hn, layer["dense_mlp"], cfg.mlp_type, quant)
    return h + y


def _transformer_block(x, layer, cfg: ModelConfig, positions, kv=None, start=0):
    """One transformer block.  With ``kv`` (one layer's KVCache) attention
    runs the chunked-prefill path, writing K/V at [start, start+S), and the
    cache is returned beside the activations."""
    h = apply_norm(x, layer["attn_norm"], cfg.norm_type)
    if kv is None:
        a = attention_forward(h, layer["attn"], cfg, positions)
    else:
        a, kv = prefill_attention(h, layer["attn"], cfg, kv, positions, start)
    out = _mlp(x + a, layer, cfg)
    return out if kv is None else (out, kv)


def forward(
    params: dict,
    cfg: ModelConfig,
    *,
    tokens: Optional[torch.Tensor] = None,  # [B, S] int
    embeds: Optional[torch.Tensor] = None,  # [B, S, d] (frontend-stub archs)
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V]."""
    _check_family(cfg, _FORWARD_FAMILIES)
    x = embeds.to(cfg.activation_dtype) if embeds is not None else params["embed"][tokens]
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    for layer in _unstack(params["layers"], cfg.num_layers):
        if cfg.remat and torch.is_grad_enabled():
            # Keep only the layer's input; recompute the rest in the backward.
            x = torch.utils.checkpoint.checkpoint(
                _transformer_block, x, layer, cfg, positions, use_reentrant=False
            )
        else:
            x = _transformer_block(x, layer, cfg, positions)
    return _logits(x, params, cfg)


def lm_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token (or frame-label) cross entropy in fp32; labels < 0 are
    masked out of the mean."""
    logits = forward(
        params, cfg,
        tokens=batch.get("tokens"), embeds=batch.get("embeds"), positions=batch.get("positions"),
    )
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (labels >= 0).float()
    nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# decode (single new token against caches)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Stacked per-layer cache (``KVCache``, or ``QuantKVCache`` under an
    int8 KV policy): leaves [L, B, max_len, ...], lengths [L, B]."""
    _check_family(cfg)
    one = init_kv_cache(cfg, batch, max_len, cfg.activation_dtype, device)
    return type(one)(*(leaf.new_zeros((cfg.num_layers, *leaf.shape)) for leaf in one))


def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, 1] int
    cache: KVCache,
    position,  # int or [B] int: absolute position per slot
) -> tuple[torch.Tensor, KVCache]:
    """One decode step -> (logits [B, 1, V], cache).  K/V are written into
    ``cache`` in place; the returned cache carries the advanced lengths."""
    _check_family(cfg)
    x = params["embed"][tokens]
    b = x.shape[0]
    pos = torch.as_tensor(position, dtype=torch.int32, device=x.device)
    pos = pos.reshape(-1, 1).expand(b, 1)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, 1, 3)

    lengths = []
    for i, layer in enumerate(_unstack(params["layers"], cfg.num_layers)):
        hn = apply_norm(x, layer["attn_norm"], cfg.norm_type)
        a, kv = decode_attention(hn, layer["attn"], cfg, _kv(cache, i), pos)
        # Dropless: a decode token's routing must not depend on its
        # lane-mates (the reference's decode_step).
        x = _mlp(x + a, layer, cfg, dropless=True)
        lengths.append(kv.lengths)
    # No logit softcap, as in the reference's decode_step.
    return _logits(x, params, cfg, softcap=False), cache._replace(lengths=torch.stack(lengths))


# ---------------------------------------------------------------------------
# prefill (whole prompt into the cache) + slot insert
# ---------------------------------------------------------------------------


def _prefill_chunk(params: dict, cfg: ModelConfig, tokens_c, cache: KVCache, start: int):
    """One prefill chunk through the stack: each layer writes its K/V into
    the cache and flash-attends over [0, start+C)."""
    x = params["embed"][tokens_c]
    b, c = tokens_c.shape
    positions = _default_positions(cfg, b, c, x.device, offset=start)
    for i, layer in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x, _ = _transformer_block(x, layer, cfg, positions, kv=_kv(cache, i), start=start)
    return _logits(x, params, cfg)


def prefill_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int, right-padded to the bucket length
    cache: KVCache,  # from ``init_cache(cfg, B, S')`` with S' >= S
    lengths,  # [B] int: true prompt length per row
    *,
    chunk_size: Optional[int] = None,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill a (padded) prompt batch into ``cache`` -> (logits [B,S,V], cache).

    ``flash_attention`` runs once per chunk of ``chunk_size`` tokens per layer
    (default: the whole prompt in one chunk); K/V go straight into the cache.
    """
    _check_family(cfg)
    b, s = tokens.shape
    chunk = min(int(chunk_size), s) if chunk_size else s
    logits = [
        _prefill_chunk(params, cfg, tokens[:, start:start + chunk], cache, start)
        for start in range(0, s, chunk)
    ]
    out = logits[0] if len(logits) == 1 else torch.cat(logits, dim=1)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=tokens.device).reshape(b)
    return out, cache._replace(lengths=lengths[None, :].expand(cfg.num_layers, b).clone())


def insert_cache(cache, prefix, slot: int):
    """Copy a prefilled cache (batch 1, seq capacity <= max_len) into batch
    slot ``slot`` of a decode cache, in place.  Every leaf is [L, B, ...]."""
    batch, max_len = cache.k.shape[1], cache.k.shape[2]
    seq = prefix.k.shape[2]
    # The reference's dynamic_update_slice would clamp an out-of-range slot
    # or an over-long prefix; no caller asks for that, so refuse it.
    if not 0 <= slot < batch or prefix.k.shape[1] != 1 or seq > max_len or type(prefix) is not type(cache):
        raise ValueError(
            f"cannot insert a {type(prefix).__name__} [B=1? {prefix.k.shape[1]}, S={seq}] prefix "
            f"into slot {slot} of a {type(cache).__name__} [B={batch}, S={max_len}]"
        )
    for name in cache._fields:
        if name == "lengths":
            cache.lengths[:, slot:slot + 1] = prefix.lengths
        else:
            getattr(cache, name)[:, slot:slot + 1, :seq] = getattr(prefix, name)
    return cache


# ---------------------------------------------------------------------------
# speculative verify (K+1 teacher-forced tokens against the live cache)
# ---------------------------------------------------------------------------


def verify_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int: [last sampled token, K draft tokens]
    cache: KVCache,  # the live decode cache; updated in place
    positions: torch.Tensor,  # [B] int: per-slot first write position
) -> tuple[torch.Tensor, KVCache]:
    """Score S teacher-forced tokens per slot in one batched forward ->
    (logits [B, S, V], cache).

    Slot i's tokens sit at positions ``positions[i] + [0, S)``; their K/V
    go into the live cache at those rows, and each token attends exactly the
    prefix a sequential ``decode_step`` would have seen, so
    ``argmax(logits[:, j])`` is vanilla greedy's token after
    ``tokens[:, :j+1]``.  ``cache.lengths`` is not advanced: the caller
    keeps the accepted prefix with ``rollback_cache``.
    """
    if cfg.family not in _FAMILIES:
        raise ValueError(
            f"verify_step requires a KV cache to roll back; family "
            f"{cfg.family!r} has none"
        )
    x = params["embed"][tokens]
    b, s = tokens.shape
    write_pos = torch.as_tensor(positions, dtype=torch.int32, device=x.device).reshape(b)
    pos = write_pos[:, None] + torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, s, 3)
    for i, layer in enumerate(_unstack(params["layers"], cfg.num_layers)):
        hn = apply_norm(x, layer["attn_norm"], cfg.norm_type)
        a, _ = verify_attention(hn, layer["attn"], cfg, _kv(cache, i), pos, write_pos)
        # Dropless, as decode_step: verify row j must equal the decode step
        # it replaces whatever its lane-mates route to.
        x = _mlp(x + a, layer, cfg, dropless=True)
    # No logit softcap, as decode_step: tanh is monotonic, so the greedy
    # argmax is unchanged.
    return _logits(x, params, cfg, softcap=False), cache


def rollback_cache(cache, new_lengths):
    """Truncate every slot's cached length to ``new_lengths`` [B].

    Rejected rows stay in the buffers but are never read (attention masks
    keys past ``lengths``) and are overwritten by the next writes.  Works for
    ``KVCache`` and ``QuantKVCache``; recurrent state has no such rollback.
    The new ``lengths`` [L, B] is its own contiguous tensor, since
    ``insert_cache`` writes it in place, slot by slot.
    """
    if not isinstance(cache, (KVCache, QuantKVCache)):
        raise ValueError(
            "rollback_cache requires a KVCache/QuantKVCache (attention "
            "families); recurrent state has no length-truncation rollback"
        )
    n_layers, b = cache.lengths.shape
    new = torch.as_tensor(new_lengths, dtype=torch.int32, device=cache.lengths.device).reshape(b)
    return cache._replace(lengths=new[None, :].expand(n_layers, b).clone())
