"""``repro_torch.quant`` — int8 quantization spanning train and serve
(counterpart of ``repro.quant``).

Pieces:
  * ``QuantConfig`` / ``parse_quant`` — the policy (config.py), carried on
    ``ModelConfig.quant`` and parsed from ``--quant`` flags;
  * ``Quant`` / ``get_quant`` — the object model code calls
    (``quant.dot(x, w, layer_class)``, ``quant.dot_batched`` for experts)
    (policy.py);
  * ``int8_dot`` / ``int8_dot_batched`` — dynamic per-row int8 quantize ->
    exact int32 product (``torch._int_mm`` on CUDA) -> dequant epilogue,
    with straight-through gradients (quantize.py);
  * ``quantize_kv`` / ``dequantize_kv`` — int8 KV-cache storage with
    per-token/per-head scales (kv.py);
  * ``quantize_int8`` / ``dequantize_int8`` — per-tensor primitives, also
    the backbone of ``repro_torch.optim.grad_compress``.
"""

from .config import LAYER_CLASSES, QUANT_FLAGS, QuantConfig, parse_quant  # noqa: F401
from .kv import dequantize_kv, quantize_kv  # noqa: F401
from .policy import Quant, get_quant  # noqa: F401
from .quantize import (  # noqa: F401
    dequantize_int8,
    int8_dot,
    int8_dot_batched,
    quantize_int8,
    quantize_rows,
    tree_bytes,
)
