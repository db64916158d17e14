"""The ``Quant`` policy object threaded through the forward path
(counterpart of ``repro.quant.policy``).

Model code calls ``quant.dot(x, w, layer_class)`` unconditionally, as in the
reference; the policy runs the plain matmul or the int8 one, keyed by the
layer class the call site declares.

Inside ``split_weights`` (entered by the mesh islands of
``models.parallel``) an int8 product of one of the named weight shards runs
as its ``Split``: with the whole operands' scales and int32 sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from .config import QuantConfig
from .quantize import Split, int8_dot, int8_dot_batched

_SPLITS: list[dict] = []


@contextlib.contextmanager
def split_weights(splits: list[tuple[torch.Tensor, Split]]):
    """Inside the block, ``Quant.dot``'s int8 product of each weight tensor
    named here (the very object) runs under its ``Split``."""
    _SPLITS.append({id(w): (w, s) for w, s in splits})
    try:
        yield
    finally:
        _SPLITS.pop()


def _split_of(w: torch.Tensor) -> Optional[Split]:
    entry = _SPLITS[-1].get(id(w)) if _SPLITS else None
    return entry[1] if entry is not None and entry[0] is w else None


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
        return int8_dot(x, w, per_channel=self.per_channel, split=_split_of(w))

    def dot_batched(self, x: torch.Tensor, w: torch.Tensor, layer_class: str) -> torch.Tensor:
        """Expert-batched ``x [E, ..., d] @ w [E, d, f]`` (MoE matmuls)."""
        if not self.active(layer_class):
            return torch.einsum("e...d,edf->e...f", x, w)
        return int8_dot_batched(x, w, per_channel=self.per_channel)


def get_quant(cfg) -> Quant:
    """Policy for a ``ModelConfig`` (a no-op policy when quant is unset)."""
    return Quant(getattr(cfg, "quant", None))
