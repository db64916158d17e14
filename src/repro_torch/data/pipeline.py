"""Deterministic, shardable data pipeline (a copy of ``repro.data.pipeline``;
numpy only, so both packages make the same batches from the same seed).

Production shape: every host generates/reads only its shard of the global
batch (``host_batch = global_batch / num_hosts``), keyed by
(seed, step, host_id) so restarts are exactly reproducible and elastic
rescaling re-partitions cleanly (the key stream is per *global example
index*, not per host).

Sources:
  * SyntheticLM — unigram-biased random token stream with a deterministic
    label shift (the default; hermetic, infinite);
  * SyntheticEmbeds — frame/patch embedding stand-ins for the [audio]/[vlm]
    frontend-stub architectures;
  * TokenFileSource — memory-mapped pre-tokenized .npy corpus for real runs.

A background prefetch thread keeps ``prefetch`` batches ready so host-side
generation overlaps device compute.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


def _example_rng(seed: int, step: int, example_idx: int) -> np.random.Generator:
    # Counter-based keying -> identical stream regardless of host layout.
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, example_idx])
    )


class SyntheticLM:
    """Zipf-ish token stream; labels are tokens shifted by one."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig):
        self.cfg, self.shape, self.data = cfg, shape, data
        if shape.global_batch % data.num_hosts:
            raise ValueError(f"global batch {shape.global_batch} not divisible by {data.num_hosts} hosts")
        self.host_batch = shape.global_batch // data.num_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        s, v = self.shape.seq_len, self.cfg.vocab_size
        toks = np.empty((self.host_batch, s + 1), np.int32)
        base = self.data.host_id * self.host_batch
        for i in range(self.host_batch):
            rng = _example_rng(self.data.seed, step, base + i)
            # Zipf-biased unigram draw, clipped to vocab.
            z = rng.zipf(1.3, size=s + 1)
            toks[i] = np.minimum(z - 1, v - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class SyntheticEmbeds:
    """Precomputed frame/patch embeddings for frontend-stub archs."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig):
        self.cfg, self.shape, self.data = cfg, shape, data
        self.host_batch = shape.global_batch // data.num_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        s, d, v = self.shape.seq_len, self.cfg.d_model, self.cfg.vocab_size
        embeds = np.empty((self.host_batch, s, d), np.float32)
        labels = np.empty((self.host_batch, s), np.int32)
        base = self.data.host_id * self.host_batch
        for i in range(self.host_batch):
            rng = _example_rng(self.data.seed, step, base + i)
            embeds[i] = rng.standard_normal((s, d)).astype(np.float32)
            labels[i] = rng.integers(0, v, size=s)
        out = {"embeds": embeds, "labels": labels}
        if self.cfg.mrope_sections is not None:
            pos = np.broadcast_to(
                np.arange(s, dtype=np.int32)[None, :, None],
                (self.host_batch, s, 3),
            ).copy()
            out["positions"] = pos
        return out


class TokenFileSource:
    """Pre-tokenized flat .npy corpus, strided deterministic sampling."""

    def __init__(self, path: str, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig):
        self.tokens = np.load(path, mmap_mode="r")
        self.cfg, self.shape, self.data = cfg, shape, data
        self.host_batch = shape.global_batch // data.num_hosts
        self.num_windows = (len(self.tokens) - 1) // shape.seq_len

    def batch(self, step: int) -> dict[str, np.ndarray]:
        s = self.shape.seq_len
        base = self.data.host_id * self.host_batch
        idx = (step * self.shape.global_batch + base + np.arange(self.host_batch)) % self.num_windows
        toks = np.stack([self.tokens[i * s : i * s + s + 1] for i in idx]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_source(cfg: ModelConfig, shape: ShapeConfig, data: DataConfig,
                token_file: Optional[str] = None):
    if token_file:
        return TokenFileSource(token_file, cfg, shape, data)
    if cfg.embedding_inputs:
        return SyntheticEmbeds(cfg, shape, data)
    return SyntheticLM(cfg, shape, data)


class PrefetchIterator:
    """Background-thread prefetch of ``source.batch(step)`` for step=start.."""

    def __init__(self, source, start_step: int = 0, prefetch: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put(self.source.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
