"""Model assembly: init / forward / loss / prefill / decode (counterpart of
``repro.models.model``) for every family:

  dense | moe | vlm | encoder — transformer stacks (the encoder family in
           ``forward`` and ``lm_loss`` only: it has no cache)
  hybrid — zamba2: Mamba2 layers and one *shared* attention(+MLP) block
           applied before every ``cfg.attn_every``-th of them (weights
           shared, one KV cache slot per application)
  ssm    — xlstm: (mLSTM, sLSTM) block pairs, attention-free

Params are plain nested dicts with the reference's keys; layer params are
stacked along a leading ``[L, ...]`` axis, and the layer ``scan`` becomes a
Python loop over layer slices (with ``cfg.remat``, each layer, hybrid layer
with its shared attention, or block pair is a ``torch.utils.checkpoint``, as
the reference's ``jax.checkpoint``).  The caches are stacked the same way:
``KVCache`` leaves ``[L, B, ...]``, ``lengths [L, B]`` (``QuantKVCache``
under an int8 KV policy); for hybrid ``{"attn": KV cache [n_attn, B, ...],
"mamba": MambaCache [L, B, ...]}``; for ssm ``{"mlstm": MLSTMState,
"slstm": SLSTMState}`` of ``[L/2, B, ...]`` leaves.  KV rows are written in
place by prefill, decode and the speculative ``verify_step``; recurrent
states are replaced by new tensors at every step.  MoE layers route with
capacity in ``forward``, ``lm_loss`` and prefill, and dropless in
``decode_step`` and ``verify_step``.  The recurrent families prefill by
teacher-forcing the prompt through ``decode_step`` (``_prefill_by_scan``),
as the reference does; they run no flash kernel when serving.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import constrain, replicate
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
from .layers import MetaGenerator, apply_norm, embed_init, mlp_forward, mlp_params, norm_params
from .moe import moe_forward, moe_params
from .parallel import embed as sharded_embed, is_dtensor, logits as sharded_logits, token_nll
from .ssm import init_mamba_cache, mamba_decode, mamba_forward, mamba_params
from .xlstm import (
    init_mlstm_state,
    init_slstm_state,
    mlstm_decode,
    mlstm_forward,
    mlstm_params,
    slstm_decode,
    slstm_forward,
    slstm_params,
)

_FAMILIES = ("dense", "moe", "vlm")  # transformer stacks with a KV cache
_RECURRENT = ("hybrid", "ssm")  # caches with recurrent state
_FORWARD_FAMILIES = _FAMILIES + _RECURRENT + ("encoder",)


def _check_family(cfg: ModelConfig, families=_FAMILIES + _RECURRENT) -> None:
    if cfg.family == "encoder" and cfg.family not in families:
        raise ValueError("encoder archs have no decode cache")
    if cfg.family not in families:
        raise ValueError(f"unknown family {cfg.family!r}")


def _n_attn(cfg: ModelConfig) -> int:
    """Applications of the hybrid family's shared attention block: one
    before each layer whose index is a multiple of ``attn_every``."""
    every = max(cfg.attn_every, 1)
    return (cfg.num_layers + every - 1) // every


def _remat(fn, cfg: ModelConfig, x, *args):
    """``fn(x, *args)``; with ``cfg.remat`` under autograd only its input is
    kept and the rest is recomputed in the backward."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


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


def _at(cache, i: int):
    """Layer ``i``'s cache (views) of a stacked cache NamedTuple."""
    return type(cache)(*(leaf[i] for leaf in cache))


def _stack_states(states: list):
    """Stack per-layer cache NamedTuples along a new axis 0."""
    return type(states[0])(*(torch.stack(leaves) for leaves in zip(*states)))


def _repeat(one, n: int):
    """A cache NamedTuple stacked ``n`` times, each leaf its own tensor."""
    return type(one)(*(leaf.expand(n, *leaf.shape).clone() for leaf in one))


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
    """Random weights from a seeded ``torch.Generator`` on ``device``; on
    the meta device, shapes and dtypes only."""
    _check_family(cfg, _FORWARD_FAMILIES)
    dtype = cfg.activation_dtype
    if torch.device(device).type == "meta":
        gen = MetaGenerator()
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device
    params: dict[str, Any] = {}
    params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    params["final_norm"] = norm_params(cfg.d_model, cfg.norm_type, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).T.contiguous()
    if cfg.family == "hybrid":
        params["mamba_layers"] = _stack([
            {"norm": norm_params(cfg.d_model, cfg.norm_type, dtype, dev), "mamba": mamba_params(gen, cfg, dtype)}
            for _ in range(cfg.num_layers)
        ])
        params["shared_attn"] = _transformer_layer_params(gen, cfg, dtype)
    elif cfg.family == "ssm":  # one (mLSTM, sLSTM) pair per block
        params["blocks"] = _stack([
            {
                "mlstm_norm": norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
                "mlstm": mlstm_params(gen, cfg, dtype),
                "slstm_norm": norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
                "slstm": slstm_params(gen, cfg, dtype),
            }
            for _ in range(cfg.num_layers // 2)
        ])
    else:
        params["layers"] = _stack(
            [_transformer_layer_params(gen, cfg, dtype) for _ in range(cfg.num_layers)]
        )
    return params


def param_shapes(cfg: ModelConfig) -> dict:
    """Abstract params (meta tensors): no allocation; the dry-run's input."""
    return init_params(cfg, 0, device="meta")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _dist(params: dict):
    """Where the params are DTensors, plain tensors (positions, masks, the
    caller's tokens) take part in DTensor ops as replicated global values."""
    return implicit_replication() if is_dtensor(params["embed"]) else contextlib.nullcontext()


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]
    return sharded_embed(table, tokens) if is_dtensor(table) else table[tokens]


def _inputs(params: dict, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    if embeds is None:
        return _embed(params, tokens)
    x = embeds.to(cfg.activation_dtype)
    return replicate(x, params["embed"].device_mesh) if is_dtensor(params["embed"]) else x


def _sp(x, cfg: ModelConfig):
    """Sequence-parallel residual sharding (Megatron-SP), as the reference:
    the layer carry, which remat checkpoints per layer, lives sharded over
    (data x model); the islands all-gather it before attention and the MLP
    and their partial sums reduce-scatter back.  Under dp_only the batch dim
    spans every axis.  The identity without an ambient mesh or DTensors."""
    if cfg.parallelism == "dp_only":
        return constrain(x, ("pod", "data", "model"), None, None)
    return constrain(x, ("pod", "data"), "model", None)


def _like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` (a plain global value) placed as the DTensor ``old`` is."""
    if not isinstance(old, DTensor) or isinstance(new, DTensor):
        return new
    return replicate(new, old.device_mesh).redistribute(old.device_mesh, old.placements)


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
    head = _head(params, cfg)
    logits = sharded_logits(x, head) if is_dtensor(head) else x @ head
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
    cache is returned beside the activations.  The carry is constrained
    (``_sp``) where the reference constrains it."""
    x = _sp(x, cfg)
    h = apply_norm(x, layer["attn_norm"], cfg.norm_type)
    if kv is None:
        a = attention_forward(h, layer["attn"], cfg, positions)
    else:
        a, kv = prefill_attention(h, layer["attn"], cfg, kv, positions, start)
    out = _sp(_mlp(_sp(x + a, cfg), layer, cfg), cfg)
    return out if kv is None else (out, kv)


def _hybrid_layer(x, layer, shared, cfg: ModelConfig, positions, with_attn: bool):
    """One zamba2 layer: the shared block first where ``with_attn``, then
    the residual Mamba2 block."""
    if with_attn:
        x = _transformer_block(x, shared, cfg, positions)
    return x + mamba_forward(apply_norm(x, layer["norm"], cfg.norm_type), layer["mamba"], cfg)


def _ssm_block(x, block, cfg: ModelConfig):
    """One xlstm block: residual mLSTM, then residual sLSTM."""
    x = x + mlstm_forward(apply_norm(x, block["mlstm_norm"], cfg.norm_type), block["mlstm"], cfg)
    return x + slstm_forward(apply_norm(x, block["slstm_norm"], cfg.norm_type), block["slstm"], cfg)


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
    with _dist(params):
        return _forward(params, cfg, tokens, embeds, positions)


def _forward(params, cfg: ModelConfig, tokens, embeds, positions) -> torch.Tensor:
    x = _inputs(params, cfg, tokens, embeds)
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    if cfg.family == "hybrid":
        every = max(cfg.attn_every, 1)
        for idx, layer in enumerate(_unstack(params["mamba_layers"], cfg.num_layers)):
            x = _remat(_hybrid_layer, cfg, x, layer, params["shared_attn"], cfg, positions, idx % every == 0)
    elif cfg.family == "ssm":
        for block in _unstack(params["blocks"], cfg.num_layers // 2):
            x = _remat(_ssm_block, cfg, x, block, cfg)
    else:
        for layer in _unstack(params["layers"], cfg.num_layers):
            x = _remat(_transformer_block, cfg, x, layer, cfg, positions)
    return _logits(x, params, cfg)


def lm_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token (or frame-label) cross entropy in fp32; labels < 0 are
    masked out of the mean."""
    with _dist(params):
        return _lm_loss(params, cfg, batch)


def _lm_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    logits = forward(
        params, cfg,
        tokens=batch.get("tokens"), embeds=batch.get("embeds"), positions=batch.get("positions"),
    )
    labels = batch["labels"]
    if is_dtensor(logits):
        nll = token_nll(logits, labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# decode (single new token against caches)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Stacked per-layer cache: a ``KVCache`` (``QuantKVCache`` under an
    int8 KV policy) of leaves [L, B, max_len, ...] and lengths [L, B]; for
    hybrid ``{"attn": that cache with n_attn layers, "mamba": MambaCache}``,
    for ssm ``{"mlstm": MLSTMState, "slstm": SLSTMState}``, their leaves
    [layers, B, ...]."""
    _check_family(cfg)
    dtype = cfg.activation_dtype
    if cfg.family == "ssm":
        n_blocks = cfg.num_layers // 2
        return {"mlstm": _repeat(init_mlstm_state(cfg, batch, device), n_blocks),
                "slstm": _repeat(init_slstm_state(cfg, batch, device), n_blocks)}
    kv = init_kv_cache(cfg, batch, max_len, dtype, device)
    if cfg.family == "hybrid":
        return {"attn": _repeat(kv, _n_attn(cfg)),
                "mamba": _repeat(init_mamba_cache(cfg, batch, dtype, device), cfg.num_layers)}
    return _repeat(kv, cfg.num_layers)


def _decode_hybrid(params, cfg: ModelConfig, x, cache: dict, pos):
    """zamba2's layers for one token: application j of the shared block
    (before layer j * attn_every) reads and writes KV slot j."""
    shared = params["shared_attn"]
    every = max(cfg.attn_every, 1)
    lengths, mamba = [], []
    for idx, layer in enumerate(_unstack(params["mamba_layers"], cfg.num_layers)):
        if idx % every == 0:
            hn = apply_norm(x, shared["attn_norm"], cfg.norm_type)
            a, kv = decode_attention(hn, shared["attn"], cfg, _at(cache["attn"], idx // every), pos)
            x = _mlp(x + a, shared, cfg, dropless=True)
            lengths.append(kv.lengths)
        hn = apply_norm(x, layer["norm"], cfg.norm_type)
        y, state = mamba_decode(hn, layer["mamba"], cfg, _at(cache["mamba"], idx))
        x = x + y
        mamba.append(state)
    return x, {"attn": cache["attn"]._replace(lengths=torch.stack(lengths)), "mamba": _stack_states(mamba)}


def _decode_ssm(params, cfg: ModelConfig, x, cache: dict):
    mlstm, slstm = [], []
    for i, block in enumerate(_unstack(params["blocks"], cfg.num_layers // 2)):
        hn = apply_norm(x, block["mlstm_norm"], cfg.norm_type)
        y, state = mlstm_decode(hn, block["mlstm"], cfg, _at(cache["mlstm"], i))
        x = x + y
        mlstm.append(state)
        hn = apply_norm(x, block["slstm_norm"], cfg.norm_type)
        y, state = slstm_decode(hn, block["slstm"], cfg, _at(cache["slstm"], i))
        x = x + y
        slstm.append(state)
    return x, {"mlstm": _stack_states(mlstm), "slstm": _stack_states(slstm)}


def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, 1] int
    cache: Any,
    position,  # int or [B] int: absolute position per slot
) -> tuple[torch.Tensor, Any]:
    """One decode step -> (logits [B, 1, V], cache).  K/V are written into
    ``cache`` in place; the returned cache carries the advanced lengths and
    the new recurrent states (``cache``'s own states are left as they
    were)."""
    _check_family(cfg)
    with _dist(params):
        return _decode_step(params, cfg, tokens, cache, position)


def _decode_step(params: dict, cfg: ModelConfig, tokens, cache, position):
    x = _embed(params, tokens)
    b = x.shape[0]
    pos = torch.as_tensor(position, dtype=torch.int32, device=x.device)
    pos = pos.reshape(-1, 1).expand(b, 1)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, 1, 3)

    if cfg.family == "hybrid":
        x, new_cache = _decode_hybrid(params, cfg, x, cache, pos)
    elif cfg.family == "ssm":
        x, new_cache = _decode_ssm(params, cfg, x, cache)
    else:
        lengths = []
        for i, layer in enumerate(_unstack(params["layers"], cfg.num_layers)):
            hn = apply_norm(x, layer["attn_norm"], cfg.norm_type)
            a, kv = decode_attention(hn, layer["attn"], cfg, _at(cache, i), pos)
            # Dropless: a decode token's routing must not depend on its
            # lane-mates (the reference's decode_step).
            x = _mlp(x + a, layer, cfg, dropless=True)
            lengths.append(kv.lengths)
        new_cache = cache._replace(lengths=torch.stack(lengths))
    # No logit softcap, as in the reference's decode_step.
    return _logits(x, params, cfg, softcap=False), new_cache


# ---------------------------------------------------------------------------
# prefill (whole prompt into the cache) + slot insert
# ---------------------------------------------------------------------------


def _prefill_chunk(params: dict, cfg: ModelConfig, tokens_c, cache: KVCache, start: int):
    """One prefill chunk through the stack: each layer writes its K/V into
    the cache and flash-attends over [0, start+C)."""
    x = _embed(params, tokens_c)
    b, c = tokens_c.shape
    positions = _default_positions(cfg, b, c, x.device, offset=start)
    for i, layer in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x, _ = _transformer_block(x, layer, cfg, positions, kv=_at(cache, i), start=start)
    return _logits(x, params, cfg)


def _freeze(keep: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` where ``keep`` [B] holds, else ``old``, leaf by leaf (batch
    at dim 1).  A leaf written in place (KV rows: ``new is old``) is kept
    as it is: a frozen slot writes its pad token's K/V at its ``lengths``,
    a row no read reaches and the next write at that length replaces."""
    if isinstance(new, dict):
        return {k: _freeze(keep, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return type(new)(*(_freeze(keep, n, o) for n, o in zip(new, old)))
    if new is old:
        return new
    return torch.where(keep.reshape((1, -1) + (1,) * (new.dim() - 2)), new, old)


def _prefill_by_scan(params: dict, cfg: ModelConfig, tokens, cache, lengths):
    """The recurrent families' prefill: teacher-force the whole (padded)
    prompt through ``decode_step``, one token at a time; each slot's state
    stops advancing past its length, so right-padding never reaches the
    recurrence (the reference's ``sel``)."""
    logits = []
    for t in range(tokens.shape[1]):
        out, new = decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        cache = _freeze(t < lengths, new, cache)
        logits.append(out[:, 0])
    return torch.stack(logits, dim=1), cache


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

    Transformer families: ``flash_attention`` runs once per chunk of
    ``chunk_size`` tokens per layer (default: the whole prompt in one
    chunk); K/V go straight into the cache.  Recurrent families (hybrid,
    ssm) teacher-force through ``decode_step`` and ignore ``chunk_size``,
    as the reference does.
    """
    _check_family(cfg)
    with _dist(params):
        return _prefill_step(params, cfg, tokens, cache, lengths, chunk_size)


def _prefill_step(params, cfg: ModelConfig, tokens, cache, lengths, chunk_size):
    b, s = tokens.shape
    if cfg.family in _RECURRENT:
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=tokens.device).reshape(b)
        return _prefill_by_scan(params, cfg, tokens, cache, lengths)
    chunk = min(int(chunk_size), s) if chunk_size else s
    logits = [
        _prefill_chunk(params, cfg, tokens[:, start:start + chunk], cache, start)
        for start in range(0, s, chunk)
    ]
    out = logits[0] if len(logits) == 1 else torch.cat(logits, dim=1)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=tokens.device).reshape(b)
    new = lengths[None, :].expand(cfg.num_layers, b).clone()
    return out, cache._replace(lengths=_like(new, cache.lengths))


def _describe(cache) -> str:
    shapes = [tuple(leaf.shape) for leaf in cache] if isinstance(cache, tuple) else ""
    return f"a {type(cache).__name__} {shapes}"


def insert_cache(cache, prefix, slot: int):
    """Copy a prefilled cache (batch 1) into batch slot ``slot`` of a decode
    cache, in place.  Family-agnostic, as the reference's: every leaf is
    [L, B, ...]; each prefix leaf lands at the start of the slot's span
    (KV rows up to the prefix's seq capacity, <= max_len; lengths and
    recurrent states whole)."""
    if isinstance(cache, dict) and isinstance(prefix, dict) and cache.keys() == prefix.keys():
        for name in cache:
            insert_cache(cache[name], prefix[name], slot)
        return cache
    # The reference's dynamic_update_slice would clamp an out-of-range slot
    # or an over-long prefix; no caller asks for that, so refuse it.
    ok = type(prefix) is type(cache) and isinstance(cache, tuple) and all(
        src.shape[1] == 1 and src.shape[0] == dst.shape[0] and src.dim() == dst.dim()
        and all(n <= m for n, m in zip(src.shape[2:], dst.shape[2:]))
        for dst, src in zip(cache, prefix)
    )
    if not ok or not 0 <= slot < cache[0].shape[1]:
        raise ValueError(f"cannot insert {_describe(prefix)} into slot {slot} of {_describe(cache)}")
    for dst, src in zip(cache, prefix):
        if isinstance(dst, DTensor):
            _insert_local(dst, src, slot)
        else:
            dst[(slice(None), slice(slot, slot + 1)) + tuple(slice(0, n) for n in src.shape[2:])] = src
    return cache


def _insert_local(dst: DTensor, src, slot: int) -> None:
    """``insert_cache`` of one DTensor leaf, on local shards: the rank
    holding ``slot`` of a batch dim sharded over the data axes writes its
    shard of the prefix (placed as the cache is: a batch of 1 is never
    sharded, other dims alike)."""
    mesh = dst.device_mesh
    local = dst.to_local()
    lo, n = 0, dst.shape[1]
    for i, p in enumerate(dst.placements):
        if p.is_shard(1):
            n //= mesh.size(i)
            lo += mesh.get_local_rank(i) * n
    if not lo <= slot < lo + n:
        return
    if not isinstance(src, DTensor):
        src = replicate(src, mesh)
    src_l = src.redistribute(mesh, [Replicate() if p.is_shard(1) else p for p in dst.placements]).to_local()
    local[(slice(None), slice(slot - lo, slot - lo + 1)) + tuple(slice(0, k) for k in src_l.shape[2:])] = src_l


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
    with _dist(params):
        return _verify_step(params, cfg, tokens, cache, positions)


def _verify_step(params: dict, cfg: ModelConfig, tokens, cache, positions):
    x = _embed(params, tokens)
    b, s = tokens.shape
    write_pos = torch.as_tensor(positions, dtype=torch.int32, device=x.device).reshape(b)
    pos = write_pos[:, None] + torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(b, s, 3)
    for i, layer in enumerate(_unstack(params["layers"], cfg.num_layers)):
        hn = apply_norm(x, layer["attn_norm"], cfg.norm_type)
        a, _ = verify_attention(hn, layer["attn"], cfg, _at(cache, i), pos, write_pos)
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
    return cache._replace(lengths=_like(new[None, :].expand(n_layers, b).clone(), cache.lengths))
