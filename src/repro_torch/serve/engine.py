"""Continuous-batching serving engine (counterpart of ``repro.serve.engine``).

Requests flow through three phases:

  * **prefill** — the whole prompt, right-padded to a power-of-two *bucket*,
    goes through ``prefill_step`` into a fresh single-request cache sized to
    the bucket; chunked flash attention writes K/V straight into it.  The
    first token is sampled from the logits of the last true position
    (padding after the prompt is harmless because attention is causal).
  * **insert** — the prefilled cache is copied into a free batch slot of the
    shared decode cache (``insert_cache``).
  * **generate** — one batched decode step advances every live slot by one
    token.  The cache keeps per-slot lengths, so requests at different
    depths share a batch; slots retire at EOS, ``max_new_tokens`` or cache
    capacity and are back-filled from the queue every step.

Runs eagerly on ``device`` (the card unless the caller asks for the CPU).
Not ported yet (ROADMAP queue 1): speculative decoding (``spec=``), the
mesh, the ``repro.obs`` registry, tracer and MFU gauges, and per-bucket
compiled executables (``compile_counts``), whose counterpart is one CUDA
graph per bucket.  ``stats`` holds plain counters.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, init_cache, insert_cache, prefill_step
from .serve_step import SamplingConfig, make_decode_step, sample_logits


@dataclasses.dataclass(eq=False)
class Request:
    # eq=False: requests are identity-equal (comparing the ndarray prompt
    # would raise); `rid` is the stable external key.
    rid: int
    prompt: np.ndarray  # [len] int32 (lists/other int dtypes are coerced)
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Lifecycle timestamps (host perf_counter seconds), set by the engine.
    t_submit: Optional[float] = None
    t_prefill: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32)


def default_buckets(max_len: int, lo: int = 16) -> tuple[int, ...]:
    """Power-of-two prefill buckets up to ``max_len``; the largest bucket
    equals the cache capacity."""
    buckets = []
    b = lo
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def request_latencies(requests) -> tuple[list[float], list[float]]:
    """(TTFT per request, mean time per output token after the first, per
    request with more than one token), in seconds."""
    ttft = [r.t_first_token - r.t_submit for r in requests]
    tpot = [
        (r.t_last_token - r.t_first_token) / (len(r.output) - 1)
        for r in requests
        if len(r.output) > 1
    ]
    return ttft, tpot


class ServeEngine:
    """Continuous-batching engine with per-slot cache state."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch_size: int = 4,
        max_len: int = 256,
        prefill_chunk: Optional[int] = None,
        prefill_buckets: Optional[tuple[int, ...]] = None,
        sampling: Optional[SamplingConfig] = None,
        device="cuda",
    ):
        if cfg.family == "encoder":
            raise ValueError("encoder archs have no decode phase")
        self.cfg, self.params = cfg, params
        self.device = torch.device(device)
        self.batch, self.max_len = batch_size, max_len
        self.prefill_chunk = prefill_chunk
        self.sampling = sampling or SamplingConfig()
        self.buckets = tuple(sorted(prefill_buckets or default_buckets(max_len)))
        if self.buckets[-1] > max_len:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds cache capacity {max_len}")

        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * batch_size
        self.cache = None
        # Host-side per-slot decode state: the position the next token will
        # be written at (== tokens cached), and the last sampled token that
        # the next generate step consumes.
        self._positions = np.zeros(batch_size, np.int32)
        self._next_tok = np.zeros(batch_size, np.int32)
        self._done: list[Request] = []
        self.stats = {"prefill_calls": 0, "insert_calls": 0, "decode_steps": 0}
        self._generator = torch.Generator(device=self.device).manual_seed(self.sampling.seed)
        self._decode = make_decode_step(cfg, sampling=self.sampling)

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the largest prefill "
                f"bucket {self.buckets[-1]}"
            )
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(plen)  # unreachable: submit() validates

    # -- engine phases ------------------------------------------------------

    def _prefill_into_slot(self, req: Request, slot: int) -> int:
        """Prefill ``req`` and insert it into ``slot``; returns its first token."""
        plen = len(req.prompt)
        bucket = self.bucket_for(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        req.t_prefill = time.perf_counter()
        prefix = init_cache(self.cfg, 1, bucket, self.device)
        logits, prefix = prefill_step(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            prefix, [plen], chunk_size=self.prefill_chunk,
        )
        tok0 = sample_logits(logits[0, plen - 1], self._generator, self.sampling)
        self.cache = insert_cache(self.cache, prefix, slot)
        tok0 = int(tok0)  # waits for the device: the first token is on the host
        req.t_first_token = req.t_last_token = time.perf_counter()
        self.stats["prefill_calls"] += 1
        self.stats["insert_calls"] += 1
        self._positions[slot] = plen
        self._next_tok[slot] = tok0
        return tok0

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        self._done.append(req)
        self.slots[slot] = None

    @torch.no_grad()
    def step(self) -> bool:
        """Back-fill free slots, then advance every live slot one token.

        Returns True while work remains (live slots or queued requests).
        """
        if self.cache is None:
            self.cache = init_cache(self.cfg, self.batch, self.max_len, self.device)
        # Insert phase: fill every free slot from the queue.  A request
        # that completes at prefill (max_new_tokens == 1 or immediate EOS)
        # retires without occupying the slot.
        for i in range(self.batch):
            while self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                tok0 = self._prefill_into_slot(req, i)
                req.output.append(tok0)
                if tok0 == req.eos_id or req.max_new_tokens <= 1:
                    req.done = True
                    self._done.append(req)
                else:
                    self.slots[i] = req

        live = [i for i in range(self.batch) if self.slots[i] is not None]
        if not live:
            return bool(self.queue)
        self._generate(live)
        return bool(self.queue or any(r is not None for r in self.slots))

    def _generate(self, live: list) -> None:
        """One batched decode step, one token per live slot."""
        nt, _logits, self.cache = self._decode(
            self.params,
            self.cache,
            torch.as_tensor(self._next_tok[:, None], device=self.device),
            torch.as_tensor(self._positions, device=self.device),
            self._generator,
        )
        nt = nt[:, 0].cpu().numpy()  # waits for the decode result
        now = time.perf_counter()
        self.stats["decode_steps"] += 1

        self._positions[live] += 1
        for i in live:
            req = self.slots[i]
            req.t_last_token = now
            tok = int(nt[i])
            req.output.append(tok)
            if (
                tok == req.eos_id
                or len(req.output) >= req.max_new_tokens
                or self._positions[i] >= self.max_len  # cache slot exhausted
            ):
                self._retire(i)
            else:
                self._next_tok[i] = tok

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drain the queue; returns completed requests."""
        steps = 0
        while steps < max_steps:
            steps += 1
            if not self.step():
                break
        done, self._done = self._done, []
        return done


@torch.no_grad()
def sequential_greedy_decode(
    cfg: ModelConfig,
    params,
    prompt: np.ndarray,
    max_new_tokens: int,
    *,
    eos_id: int = -1,
    max_len: Optional[int] = None,
) -> list[int]:
    """Obviously-correct single-request baseline on the params' device:
    teacher-forced per-token prefill through ``decode_step`` plus greedy
    decode, batch 1.  The engine's token-equivalence checks hold continuous
    batching against exactly this."""
    device = params["embed"].device
    plen = len(prompt)
    max_len = max_len or plen + max_new_tokens
    cache = init_cache(cfg, 1, max_len, device)
    logits = None
    for i in range(plen):
        t = torch.tensor([[int(prompt[i])]], device=device)
        logits, cache = decode_step(params, cfg, t, cache, i)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = plen
    while len(out) < max_new_tokens and out[-1] != eos_id and pos < max_len:
        t = torch.tensor([[out[-1]]], device=device)
        logits, cache = decode_step(params, cfg, t, cache, pos)
        out.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return out
