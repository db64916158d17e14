"""The draft side of speculative decoding: a model whose cache mirrors the
engine's slot lifecycle (counterpart of ``repro.spec.draft``).

The ``DraftWorker`` owns a second decode cache over the same slot pool as
the target engine, also under self-draft, where it shares the target's
params: every target prefill/insert is mirrored here (same bucket, same
slot), and every verify round rolls the draft back to the target's accepted
length.  So draft ``lengths[i]`` always equals the target's, and a round's
proposals start from a synchronized context.

Per round the draft runs K+1 greedy decode steps, not K: the last step feeds
the final proposal ``d_K`` back in (its token is discarded) only to write
``d_K``'s K/V.  The cache then stays dense through position ``pos + K``, so
a fully accepted round needs no catch-up next round, and self-draft
acceptance stays 1.0.  The proposals stay on the device across those steps
and reach the host once per round.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import insert_cache, prefill_step, rollback_cache
from repro_torch.serve.serve_step import Executables, make_decode_step, new_cache


class DraftWorker:
    """Draft-model proposer with a mirrored per-slot decode cache."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch_size: int,
        max_len: int,
        prefill_chunk: Optional[int] = None,
        device="cuda",
        mesh=None,  # the engine's DeviceMesh where ``params`` are DTensors
    ):
        self.cfg, self.params, self.mesh = cfg, params, mesh
        self.batch, self.max_len = batch_size, max_len
        self.prefill_chunk = prefill_chunk
        self.device = torch.device(device)
        self.cache = None
        self._positions = np.zeros(batch_size, np.int32)
        self._decode = make_decode_step(cfg)  # greedy
        self._executables = Executables()

    def compile_counts(self) -> dict:
        """Argument signatures per draft phase (``serve_step.Executables``)."""
        return {f"draft_{k}": n for k, n in self._executables.counts(("prefill", "insert", "generate")).items()}

    def ensure_cache(self) -> None:
        if self.cache is None:
            self.cache = new_cache(self.cfg, self.batch, self.max_len, self.device, self.mesh)

    def prefill_into_slot(self, prompt: np.ndarray, slot: int, bucket: int) -> None:
        """Mirror the target's prefill+insert for ``slot`` (same bucket).  The
        draft's prefill logits are discarded: the first token always comes
        from the target's prefill."""
        self.ensure_cache()
        plen = len(prompt)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = prompt
        tokens = torch.as_tensor(toks, device=self.device)
        self._executables.see("prefill", tokens)
        prefix = new_cache(self.cfg, 1, bucket, self.device, self.mesh)
        _, prefix = prefill_step(self.params, self.cfg, tokens, prefix, [plen], chunk_size=self.prefill_chunk)
        self._executables.see("insert", self.cache, prefix)
        self.cache = insert_cache(self.cache, prefix, slot)
        self._positions[slot] = plen

    def propose(self, next_tok: np.ndarray, k: int) -> np.ndarray:
        """K greedy draft tokens per slot, [B, K], plus one extra decode step
        that writes the last proposal's K/V (its token discarded)."""
        tok = torch.as_tensor(next_tok.reshape(-1, 1).astype(np.int32), device=self.device)
        pos = torch.as_tensor(self._positions, device=self.device)
        drafts = []
        for j in range(k + 1):
            self._executables.see("generate", self.cache, tok, pos)
            tok, _, self.cache = self._decode(self.params, self.cache, tok, pos + j)
            if j < k:
                drafts.append(tok[:, 0])
        self._positions += k + 1
        return torch.stack(drafts, dim=1).cpu().numpy()  # the round's one read

    def rollback(self, new_lengths: np.ndarray) -> None:
        """Truncate to the target's accepted lengths after a verify round."""
        new_lengths = new_lengths.astype(np.int32)
        self.cache = rollback_cache(self.cache, torch.as_tensor(new_lengths, device=self.device))
        self._positions = new_lengths.copy()
