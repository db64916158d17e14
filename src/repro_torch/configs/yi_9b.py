"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-architecture GQA.  [arXiv:2403.04652; hf]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    mlp_type="swiglu",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
