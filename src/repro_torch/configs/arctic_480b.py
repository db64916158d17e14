"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual.  [hf:Snowflake/snowflake-arctic-base; hf]
Arctic is a dense-MoE hybrid: a small dense FFN runs in residual parallel
with the routed experts."""
import dataclasses
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96, dense_residual=True),
    dtype="float32", remat=False,
)
