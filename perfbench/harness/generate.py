"""The one traffic generator: it reads a traffic mix's parameters (a JSON
file under ``perfbench/traffic/``) and makes the requests or batches of a
run from ``--seed``.

Every seed gets the same work in another order.  Requests come in blocks
of ``block`` requests; each block holds the same multiset of sizes (the
distribution's quantiles at (i + 1/2) / block, clipped and rounded), in an
order drawn from the seed, and in an open loop the same multiset of gaps
(exponential quantiles scaled so that a block lasts ``block / rate``
seconds), shuffled apart from the sizes.  So a window that spans whole
blocks holds the same tokens on every seed, while arrivals keep their
bursts.  Token ids are drawn from the seed over the whole vocabulary.

Distributions: ``lognormal`` (median, sigma), ``loguniform`` and
``uniform`` (both over [min, max]); every one is clipped to [min, max].
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantile(dist: dict, u: float) -> float:
    kind = dist["dist"]
    lo, hi = dist["min"], dist["max"]
    if kind == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
    elif kind == "loguniform":
        x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return min(max(x, lo), hi)


def block_sizes(dist: dict, n: int) -> np.ndarray:
    """The ``n`` stratified sizes of one block, ascending."""
    return np.array([int(round(quantile(dist, (i + 0.5) / n))) for i in range(n)], np.int64)


def block_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` stratified exponential gaps of one block, summing to n / rate."""
    g = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    return g * (n / rate) / g.sum()


class Requests:
    """An endless, seeded stream of requests for a serving mix.

    ``next()`` gives ``(prompt, max_new_tokens, gap_s)``; ``gap_s`` is the
    time since the previous arrival (open loop) or None (closed loop)."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.traffic, self.vocab = traffic, vocab
        self.rng = np.random.default_rng(seed)
        self.n = traffic["block"]
        self.prompts = block_sizes(traffic["prompt"], self.n)
        self.outputs = block_sizes(traffic["output"], self.n)
        rate = traffic.get("rate_per_s")
        self.gaps = block_gaps(rate, self.n) if rate else None
        self._block: list = []

    def _refill(self) -> None:
        p = self.rng.permutation(self.prompts)
        o = self.rng.permutation(self.outputs)
        g = self.rng.permutation(self.gaps) if self.gaps is not None else [None] * self.n
        self._block = list(zip(p.tolist(), o.tolist(), list(g)))[::-1]

    def next(self):
        if not self._block:
            self._refill()
        plen, out, gap = self._block.pop()
        prompt = self.rng.integers(1, self.vocab, size=plen, dtype=np.int64).astype(np.int32)
        return prompt, int(out), gap


def train_batch(vocab: int, batch: int, seq_len: int, seed: int, step: int) -> dict:
    """Step ``step``'s batch: fresh token ids over the whole vocabulary, the
    labels the tokens shifted by one (the trainer's data-source layout)."""
    rng = np.random.default_rng([seed, step])
    toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int64).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
