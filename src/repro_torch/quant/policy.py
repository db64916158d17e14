"""The ``Quant`` policy object threaded through the forward path
(counterpart of ``repro.quant.policy``).

Model code calls ``quant.dot(x, w, layer_class)`` unconditionally, as in the
reference; the policy runs the plain matmul or the int8 one, keyed by the
layer class the call site declares.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import QuantConfig
from .quantize import int8_dot, int8_dot_batched


@dataclasses.dataclass(frozen=True)
class Quant:
    cfg: Optional[QuantConfig] = None

    def active(self, layer_class: str) -> bool:
        return self.cfg is not None and self.cfg.active_for(layer_class)

    @property
    def per_channel(self) -> bool:
        return self.cfg is not None and self.cfg.granularity == "per_channel"

    @property
    def quantized_kv(self) -> bool:
        return self.cfg is not None and self.cfg.kv_cache

    def dot(self, x: torch.Tensor, w: torch.Tensor, layer_class: str) -> torch.Tensor:
        """``x [..., d] @ w [d, f]``, int8 when the policy covers the class."""
        if not self.active(layer_class):
            return x @ w
        return int8_dot(x, w, per_channel=self.per_channel)

    def dot_batched(self, x: torch.Tensor, w: torch.Tensor, layer_class: str) -> torch.Tensor:
        """Expert-batched ``x [E, ..., d] @ w [E, d, f]`` (MoE matmuls)."""
        if not self.active(layer_class):
            return torch.einsum("e...d,edf->e...f", x, w)
        return int8_dot_batched(x, w, per_channel=self.per_channel)


def get_quant(cfg) -> Quant:
    """Policy for a ``ModelConfig`` (a no-op policy when quant is unset)."""
    return Quant(getattr(cfg, "quant", None))
