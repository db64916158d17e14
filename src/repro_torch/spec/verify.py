"""The batched verify pass: score K drafts per slot, accept, roll back
(counterpart of ``repro.spec.verify``).

One call per round replaces up to K+1 sequential target decode steps: the K
small products of sequential decode become one wide teacher-forced forward
(``verify_step``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import full
from repro_torch.models import rollback_cache, verify_step


def make_spec_verify(cfg: ModelConfig):
    """Build the engine's verify closure.

    ``spec_verify(params, cache, tokens [B, K+1], positions [B])`` returns,
    all on the cache's device:

      * ``greedy [B, K+1]`` — the target's greedy token at every verified
        position (``greedy[:, j]`` is the argmax given the cached prefix
        plus ``tokens[:, :j+1]``);
      * ``accepted [B]`` — per slot, the length of the longest draft prefix
        the target agrees with (0..K), capped at ``max_len - positions - 1``
        so the emitted run never outgrows the cache;
      * the cache with the K+1 rows written and ``lengths`` rolled back to
        ``positions + accepted + 1``.

    Greedy acceptance makes losslessness structural: an accepted draft
    ``tokens[:, j+1]`` equals ``greedy[:, j]``, so the emitted stream
    ``greedy[:, :accepted+1]`` is the target's own greedy continuation.
    """

    def spec_verify(params, cache, tokens, positions):
        logits, cache = verify_step(params, cfg, tokens, cache, positions)
        # Under a mesh every rank reads the full logits, as sampling does.
        greedy = torch.argmax(full(logits).float(), dim=-1).to(torch.int32)
        # accepted = longest prefix with draft[j] == greedy[j]; cumprod
        # zeroes everything after the first mismatch.
        match = (greedy[:, :-1] == tokens[:, 1:]).to(torch.int32)
        accepted = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
        max_len = cache.k.shape[2]  # [L, B, max_len, ...]
        cap = (max_len - positions - 1).clamp(min=0).to(torch.int32)
        accepted = torch.minimum(accepted, cap)
        cache = rollback_cache(cache, positions + accepted + 1)
        return greedy, accepted, cache

    return spec_verify
