"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]
Qwen3 uses QK-Norm and no QKV bias."""
import dataclasses
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96),
    dtype="float32", remat=False,
)
