"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.  GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
