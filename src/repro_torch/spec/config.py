"""Speculative-decoding policy configuration (a copy of ``repro.spec.config``
on the port's configs).

``SpecConfig`` is the policy the serving engine carries: which model drafts
(an arch id from the registry, or ``None`` for self-draft), under what
quantization, how many tokens it looks ahead per round, and how proposals
are accepted.  Frozen and hashable, like ``ModelConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.quant.config import QuantConfig, parse_quant

# Families whose decode cache is a KV cache and therefore supports the
# lengths-truncation rollback spec decoding needs.  Recurrent families
# (hybrid/ssm) carry state that cannot be rolled back by truncation.
ROLLBACK_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding policy.

    ``draft_arch`` names a registry smoke config for the draft model, or
    ``None`` for self-draft (draft == target: the lossless sanity
    configuration whose acceptance rate must be 1.0).  ``draft_quant``
    overlays an int8 policy on the draft only (the target keeps the
    engine's config): a near-free int8 draft, exact verify.  ``lookahead``
    is K, the number of draft tokens verified per round; each round emits
    between 1 and K+1 tokens.
    """

    draft_arch: Optional[str] = None  # None: self-draft (target cfg/params)
    draft_quant: Union[QuantConfig, str, None] = None
    lookahead: int = 4
    acceptance: str = "greedy"

    def __post_init__(self):
        if self.lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {self.lookahead}")
        if self.acceptance != "greedy":
            raise ValueError(
                f"unknown acceptance rule {self.acceptance!r} (only 'greedy' "
                f"— exact target-argmax match — is implemented)"
            )
        if isinstance(self.draft_quant, str):
            # Normalize the CLI-flag form eagerly so equal policies hash equal.
            object.__setattr__(self, "draft_quant", parse_quant(self.draft_quant))


def resolve_draft_config(spec: SpecConfig, target: ModelConfig) -> ModelConfig:
    """The draft's ModelConfig: registry smoke config or the target itself,
    with the draft-side quantization overlaid.  Validates that draft and
    target can speculate together."""
    if target.family not in ROLLBACK_FAMILIES:
        raise ValueError(
            f"speculative decoding needs a KV-cache target for rollback; "
            f"family {target.family!r} is recurrent"
        )
    cfg = target if spec.draft_arch is None else get_smoke_config(spec.draft_arch)
    if spec.draft_quant is not None:
        cfg = dataclasses.replace(cfg, quant=spec.draft_quant)
    if cfg.family not in ROLLBACK_FAMILIES:
        raise ValueError(
            f"draft family {cfg.family!r} has no KV rollback; pick an "
            f"attention-family draft"
        )
    if cfg.vocab_size != target.vocab_size:
        raise ValueError(
            f"draft vocab {cfg.vocab_size} != target vocab "
            f"{target.vocab_size}: drafted ids must be valid target inputs"
        )
    return cfg
