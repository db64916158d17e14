"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Mamba2 backbone + ONE shared attention(+MLP) block applied
every 6 Mamba layers (weights shared across applications, per-application KV
caches).  [arXiv:2411.15242; hf]
Sub-quadratic end-to-end -> runs the long_500k cell."""
import dataclasses
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2, chunk_size=128),
    attn_every=6,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm=SSMConfig(state_dim=8, head_dim=16, conv_width=4, expand=2, chunk_size=16),
    attn_every=2, dtype="float32", remat=False,
)
