"""int8 gradient compression with error feedback (counterpart of
``repro.optim.grad_compress``).

Each gradient leaf plus the residual carried from the last step is
quantized to int8 with one per-tensor scale; the dequantized value feeds the
optimizer and the quantization error becomes the next residual, so no
gradient mass is lost over steps.  The reference's ``compressed_pmean``
(the int8 all-reduce across a mesh axis) waits for the port's distribution
(ROADMAP queue 1 item 8); on one device the compressed step is this
quantize-dequantize round trip.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.quant.quantize import dequantize_int8, quantize_int8
from .adamw import _unzip, tree_map

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "compress_with_feedback",
    "init_residual",
]


def compress_with_feedback(grads: Any, residual: Any) -> tuple[Any, Any, Any]:
    """Quantize (grads + residual); return (q, scales, new_residual)."""

    def one(g, r):
        g32 = g.float() + r
        q, s = quantize_int8(g32)
        return q, s, g32 - dequantize_int8(q, s)  # residual = quantization error

    return _unzip(tree_map(one, grads, residual), 3)


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
