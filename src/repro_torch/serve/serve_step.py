"""Serving steps: the sampling policy and the decode step closure
(counterpart of ``repro.serve.serve_step``).  Per the paper §8.3 the
FSA/flash path runs in prefill only; decode is the memory-bound path.

Sampling draws from an explicit ``torch.Generator``; its numbers differ from
``jax.random``'s, so only greedy decoding gives the reference's tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import full
from repro_torch.dist.sharding import cache_shardings, place
from repro_torch.models.model import decode_step, forward, init_cache


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling policy, applied in order: temperature -> top-k -> top-p.

    ``temperature == 0`` means greedy argmax (top_k/top_p ignored).
    """

    temperature: float = 0.0
    top_k: int = 0  # 0: no top-k truncation
    top_p: float = 1.0  # 1.0: no nucleus truncation
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sample_logits(
    logits: torch.Tensor,  # [..., V]
    generator: Optional[torch.Generator],
    scfg: SamplingConfig,
) -> torch.Tensor:
    """Sample token ids (int32) from logits under the configured policy
    (a DTensor's full logits: sampling runs on every rank alike)."""
    logits = full(logits).float()
    if scfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / scfg.temperature
    if scfg.top_k > 0:
        kth = torch.topk(logits, scfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if scfg.top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        # Keep the smallest prefix whose mass reaches top_p (the argmax
        # token always survives: its cum-prob term starts the prefix).
        keep = torch.cumsum(probs, dim=-1) - probs < scfg.top_p
        kth = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)


def make_prefill_step(cfg: ModelConfig):
    """Prefill step closure ``(params, batch) -> last-position logits
    [B, V]`` (the dry-run's prefill cell: the whole prompt through
    ``forward``; serving samples from the last position)."""

    def prefill_step(params, batch):
        logits = forward(
            params, cfg,
            tokens=batch.get("tokens"), embeds=batch.get("embeds"), positions=batch.get("positions"),
        )
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, sampling: Optional[SamplingConfig] = None):
    """Decode step closure ``(params, cache, tokens, position, generator)
    -> (next tokens [B, 1], logits, cache)``; ``generator`` is read only by
    a stochastic policy."""
    scfg = sampling or SamplingConfig()

    def serve_step(params, cache, tokens, position, generator=None):
        logits, new_cache = decode_step(params, cfg, tokens, cache, position)
        next_tok = sample_logits(logits[:, -1, :], generator, scfg)
        return next_tok[:, None], logits, new_cache

    return serve_step


def new_cache(cfg: ModelConfig, batch: int, max_len: int, device, mesh=None):
    """A zeroed decode cache, placed per ``cache_shardings`` on ``mesh``."""
    cache = init_cache(cfg, batch, max_len, device)
    return cache if mesh is None else place(cache, cache_shardings(cache, cfg, mesh))


def _signature(tree) -> tuple:
    """Shapes and dtypes of the tensor leaves of ``tree`` (dicts, tuples,
    lists), in order; other leaves by type."""
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return type(tree).__name__


class Executables:
    """The distinct argument signatures each engine phase has run, the
    counterpart of the reference's per-phase jit cache sizes: ``jax.jit``
    holds one executable per signature, so on the same requests these are
    its counts (prefill: buckets touched; insert: prefix shapes; generate,
    verify: one), and the set a captured CUDA graph per phase would take.
    The engine's fixed params are not part of a signature."""

    def __init__(self):
        self._seen: dict[str, set] = {}

    def see(self, phase: str, *args) -> None:
        self._seen.setdefault(phase, set()).add(_signature(args))

    def counts(self, phases) -> dict:
        return {phase: len(self._seen.get(phase, ())) for phase in phases}
