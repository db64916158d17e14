"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000.  Squared-ReLU MLP (no gate), GQA.  [arXiv:2402.16819]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="squared_relu",
    norm_type="layernorm",
    rope_theta=10_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, dtype="float32", remat=False,
)
