"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504.
Encoder-only (bidirectional), same backbone as wav2vec2.  [arXiv:2106.07447]
The conv waveform frontend is a STUB: input_specs() provides precomputed
frame embeddings [B, S, d]; the head predicts one of 504 cluster labels per
frame.  Non-causal attention is exactly the paper's evaluated setting."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    norm_type="layernorm",
    causal=False,
    embedding_inputs=True,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, dtype="float32", remat=False,
)
