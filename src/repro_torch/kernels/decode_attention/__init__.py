"""Decode attention over a KV cache: the hand-written CUDA kernel
``kernels/csrc/decode_attention.cu`` beside its plain PyTorch version."""
from .kernel import decode_attention_fwd, decode_attention_plain  # noqa: F401
