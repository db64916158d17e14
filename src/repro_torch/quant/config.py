"""Quantization policy configuration (pure data): a copy of
``repro.quant.config``, so that ``ModelConfig.quant`` compares equal.

``QuantConfig`` is the serializable policy carried on ``ModelConfig.quant``
and threaded MaxText-style through every layer: which layer classes run
int8 matmuls, how weights are scaled (per-tensor vs per-output-channel),
and whether the KV cache stores int8 payloads.  It is a frozen dataclass
(hashable) so configs stay valid jit static arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Layer classes the policy can name.  Matmuls outside these (embedding
# lookup, lm_head, router, norms) always stay full precision.
LAYER_CLASSES = ("mlp", "attention", "moe", "ssm", "xlstm")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """int8 quantization policy.

    Activations are always dynamically quantized **per row** (one symmetric
    scale per token vector) — this is what keeps chunked-prefill and
    per-token decode bit-identical, so the serve engine's token-equivalence
    contract survives quantization.  ``granularity`` controls the weight
    side only.
    """

    dtype: str = "int8"
    granularity: str = "per_channel"  # per_channel | per_tensor (weights)
    layer_classes: tuple[str, ...] = LAYER_CLASSES
    kv_cache: bool = True  # store K/V as int8 with per-token/head scales

    def __post_init__(self):
        if self.dtype != "int8":
            raise ValueError(f"unsupported quant dtype {self.dtype!r}")
        if self.granularity not in ("per_channel", "per_tensor"):
            raise ValueError(f"unknown granularity {self.granularity!r}")
        bad = set(self.layer_classes) - set(LAYER_CLASSES)
        if bad:
            raise ValueError(f"unknown layer classes {sorted(bad)}")

    def active_for(self, layer_class: str) -> bool:
        return layer_class in self.layer_classes


def parse_quant(flag: Optional[str]) -> Optional[QuantConfig]:
    """CLI flag -> policy.

    none            -> None (fully disabled)
    int8            -> per-channel weights + int8 KV cache (the default policy)
    int8-per-tensor -> per-tensor weight scales
    int8-kv-only    -> full-precision matmuls, int8 KV cache only
    int8-no-kv      -> int8 matmuls, full-precision KV cache
    """
    if flag is None or flag in ("none", "fp", "off"):
        return None
    if flag == "int8":
        return QuantConfig()
    if flag == "int8-per-tensor":
        return QuantConfig(granularity="per_tensor")
    if flag == "int8-kv-only":
        return QuantConfig(layer_classes=(), kv_cache=True)
    if flag == "int8-no-kv":
        return QuantConfig(kv_cache=False)
    raise ValueError(f"unknown --quant flag {flag!r}")


QUANT_FLAGS = ("none", "int8", "int8-per-tensor", "int8-kv-only", "int8-no-kv")
