"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064.  M-RoPE (t/h/w sections), dynamic resolution.  [arXiv:2409.12191]
The vision frontend is a STUB: train/prefill consume precomputed patch
embeddings + 3D positions from input_specs(); decode embeds generated tokens.
M-RoPE sections (16, 24, 24) partition the 64 head_dim/2 slots."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    embedding_inputs=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, mrope_sections=(4, 2, 2),
    dtype="float32", remat=False,
)
