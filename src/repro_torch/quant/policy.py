"""The ``Quant`` policy object threaded through the forward path
(counterpart of ``repro.quant.policy``).

Model code calls ``quant.dot(x, w, layer_class)`` unconditionally, as in the
reference.  Only the full-precision policy (``cfg.quant is None``) exists in
this port: the int8 matmuls and the int8 KV cache come with the int8 item of
ROADMAP queue 1, and any int8 policy raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import QuantConfig


@dataclasses.dataclass(frozen=True)
class Quant:
    cfg: Optional[QuantConfig] = None

    def __post_init__(self):
        if self.cfg is not None:
            raise NotImplementedError(
                "int8 quantization is not ported yet (ROADMAP queue 1, int8)"
            )

    def dot(self, x: torch.Tensor, w: torch.Tensor, layer_class: str) -> torch.Tensor:
        """``x [..., d] @ w [d, f]`` in the activations' precision."""
        return x @ w


def get_quant(cfg) -> Quant:
    """Policy for a ``ModelConfig``; raises for an int8 policy."""
    return Quant(getattr(cfg, "quant", None))
