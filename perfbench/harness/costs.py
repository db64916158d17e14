"""The yardstick's arithmetic: peaks of the card, model FLOPs, and the
operations and bytes of the attention kernels, all from shapes.

Frozen copies, so that a later change to the program cannot move them:

  * the model-FLOPs formulas of ``repro_torch.obs.mfu`` (PaLM accounting:
    2 FLOPs per active parameter per token forward, 3x for forward and
    backward, plus the causal attention term ``4 * ctx * head_dim * heads``
    per token and layer), with the parameter counts of
    ``ModelConfig.param_count`` / ``active_param_count`` for the dense and
    MoE families;
  * ``chip_smoke._attention_cost`` and ``chip_smoke._bwd_cost``.

The denominator is one H100 SXM's published dense bf16 peak, not the
paper's FSA array that ``obs/mfu.py`` divides by.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16, 700 W
PEAK_BYTES = 3.35e12  # HBM3, B/s


# -- parameter counts (dense and MoE transformer families) ---------------------

def param_count(m: dict) -> int:
    """Parameters of the model described by a config's ``port`` block."""
    d, v, n_layers = m["d_model"], m["vocab_size"], m["num_layers"]
    hd = m["head_dim"]
    emb = v * d * (1 if m.get("tie_embeddings") else 2)
    attn = d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd + m["num_heads"] * hd * d
    moe = m.get("moe")
    if moe is None:
        per_layer = attn + 3 * d * m["d_ff"]  # SwiGLU
    else:
        per_layer = attn + moe["num_experts"] * 3 * d * moe["d_ff_expert"] + d * moe["num_experts"]
    return emb + n_layers * per_layer


def active_param_count(m: dict) -> int:
    """Parameters a token passes through (MoE: its top-k experts)."""
    moe = m.get("moe")
    if moe is None:
        return param_count(m)
    inactive = (moe["num_experts"] - moe["top_k"]) * 3 * m["d_model"] * moe["d_ff_expert"]
    return param_count(m) - m["num_layers"] * inactive


# -- model FLOPs ---------------------------------------------------------------

def attn_flops_per_token(m: dict, context: float) -> float:
    """QK^T and PV for one query over ``context`` keys, every head and layer."""
    return 4.0 * context * m["head_dim"] * m["num_heads"] * m["num_layers"]


def train_step_flops(m: dict, batch: int, seq_len: int) -> float:
    """One step over ``batch`` rows of ``seq_len``: 6 per active parameter
    per token, and causal attention (mean context seq/2) at 3x forward.
    Remat's recomputed forward is not counted (model FLOPs)."""
    tokens = float(batch) * seq_len
    return 6.0 * active_param_count(m) * tokens + 3.0 * attn_flops_per_token(m, seq_len / 2.0) * tokens


def prefill_flops(m: dict, prompt_len: int) -> float:
    """Forward over one prompt's true tokens (token i attends to i+1 keys)."""
    return 2.0 * active_param_count(m) * prompt_len + attn_flops_per_token(m, (prompt_len + 1) / 2.0) * prompt_len


def decode_token_flops(m: dict, context: int) -> float:
    """One decoded token whose query sees ``context`` cached keys and itself."""
    return 2.0 * active_param_count(m) + attn_flops_per_token(m, context + 1.0)


def mfu(flops: float, seconds: float) -> float:
    """Share of the card's bf16 peak, in %."""
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)


# -- attention kernels ------------------------------------------------------------

def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attention_fwd_cost(b: int, s: int, h: int, d: int, itemsize: int, hkv: int | None = None):
    """Causal forward: (operations, bytes); q, k, v read once, o written once."""
    flops = 4 * d * causal_pairs(s) * h * b
    nbytes = 2 * b * s * (h + (hkv or h)) * d * itemsize
    return flops, nbytes


def attention_bwd_cost(b: int, s: int, h: int, hkv: int, d: int, itemsize: int,
                       products: int = 5, q_sized: int = 4, kv_sized: int = 4):
    """Causal backward: ``products`` d-deep products per causal pair and head
    (FA-2 needs five: S, dP, dV, dK, dQ); bytes of ``q_sized`` [B, S, H, d]
    tensors (q, o, dO, dQ), ``kv_sized`` [B, S, Hkv, d] tensors (k, v, dK,
    dV) and of LSE and delta in fp32, each once."""
    flops = 2 * products * d * causal_pairs(s) * h * b
    nbytes = (q_sized * b * s * h + kv_sized * b * s * hkv) * d * itemsize + 2 * b * h * s * 4
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: max(ops / peak, bytes / bandwidth)."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
