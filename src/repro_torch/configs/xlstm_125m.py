"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.
Alternating sLSTM + mLSTM blocks; attention-free (the paper's technique is
inapplicable — DESIGN.md §5).  [arXiv:2405.04517]
Constant-size recurrent state -> runs the long_500k cell."""
import dataclasses
from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,          # 6 scanned (mLSTM, sLSTM) pairs
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    mlp_type="gelu",
    tie_embeddings=True,
    xlstm=XLSTMConfig(),
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    vocab_size=256, dtype="float32", remat=False,
)
