"""int8 gradient compression with error feedback (counterpart of
``repro.optim.grad_compress``).

Each gradient leaf plus the residual carried from the last step is
quantized to int8 with one per-tensor scale; the dequantized value feeds the
optimizer and the quantization error becomes the next residual, so no
gradient mass is lost over steps.  On one device the compressed step is
this quantize-dequantize round trip; across a mesh axis,
``compressed_pmean`` averages the dequantized payloads of the axis's ranks,
inside an island on local tensors, as ``dist.collectives.psum_mean`` is
used (the reference's shard_map'd train step)::

    g_pod = psum_mean(grads, "data")                        # cheap intra-pod
    g, new_residual = compressed_pmean(g_pod, residual, "pod")

The numerics are the reference's: each rank's ``q * s`` in fp32, summed over
the axis and divided by its size.  The sum travels as fp32, as the
reference's ``psum`` does; an int8 wire format would be a speed matter.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist.collectives import psum_mean
from repro_torch.quant.quantize import dequantize_int8, quantize_int8
from .adamw import _unzip, tree_map

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "compress_with_feedback",
    "compressed_pmean",
    "init_residual",
]


def compress_with_feedback(grads: Any, residual: Any) -> tuple[Any, Any, Any]:
    """Quantize (grads + residual); return (q, scales, new_residual)."""

    def one(g, r):
        g32 = g.float() + r
        q, s = quantize_int8(g32)
        return q, s, g32 - dequantize_int8(q, s)  # residual = quantization error

    return _unzip(tree_map(one, grads, residual), 3)


def compressed_pmean(grads: Any, residual: Any, axis_name: str, mesh=None) -> tuple[Any, Any]:
    """int8 all-reduce with error feedback across ``axis_name`` of ``mesh``
    (the ambient mesh by default), on local tensors.  Returns (averaged
    grads fp32, new residual)."""
    q, s, new_r = compress_with_feedback(grads, residual)
    avg = tree_map(lambda qi, si: psum_mean(qi.float() * si, axis_name, mesh), q, s)
    return avg, new_r


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
