"""Continuous-batching serving engine (counterpart of ``repro.serve.engine``).

Requests flow through three phases:

  * **prefill** — the whole prompt, right-padded to a power-of-two *bucket*,
    goes through ``prefill_step`` into a fresh single-request cache sized to
    the bucket; chunked flash attention writes K/V straight into it.  The
    recurrent families (hybrid, ssm) teacher-force the bucket through
    ``decode_step`` instead, their state frozen past the prompt, and ignore
    ``prefill_chunk``, as the reference does.  The first token is sampled
    from the logits of the last true position (padding after the prompt is
    harmless because attention is causal).
  * **insert** — the prefilled cache is copied into a free batch slot of the
    shared decode cache (``insert_cache``: KV rows, lengths and recurrent
    states alike).
  * **generate** — one batched decode step advances every live slot by one
    token.  The cache keeps per-slot lengths, so requests at different
    depths share a batch; slots retire at EOS, ``max_new_tokens`` or cache
    capacity and are back-filled from the queue every step.

With ``spec=SpecConfig(...)`` (``repro_torch.spec``) the generate phase
runs speculatively: a draft model proposes K greedy tokens per slot, the
target verifies all of them in one wide teacher-forced forward against the
live cache, and rejected suffixes roll back by per-slot length truncation.
Greedy outputs stay token-equal to vanilla decode; only the step count
changes.

Telemetry (``repro_torch.obs``): every engine owns a metrics ``Registry`` —
request-lifecycle histograms (``serve_ttft_seconds``,
``serve_tpot_seconds``, ``serve_queue_wait_seconds``,
``serve_prefill_seconds``), slot-occupancy / batch-utilization /
queue-depth gauges, spec acceptance, and per-phase MFU gauges against the
paper's FSA array (``repro_torch.obs.mfu``).  ``stats`` is a property over
the ``serve_*_total`` counters.  With a real ``Tracer`` installed, phases
emit live spans and each retired request leaves queued/decode spans on its
slot's lane.  The telemetry reads nothing from the device beyond the reads
the engine makes anyway (the sampled tokens).  Device spans (a vanilla
step's ``decode_step``, each layer's ``decode_attention``) are timed on the
device's clock and flushed after each step.

Runs eagerly on ``device`` (the card unless the caller asks for the CPU).
With ``mesh`` (a ``DeviceMesh`` over ("data", "model"); the params placed by
the caller, ``repro_torch.dist.sharding.param_shardings``) the caches are
placed per ``cache_shardings`` and every phase runs under the ambient mesh,
speculative decoding included: a draft with DTensor params (a self-draft
shares the target's) places its own cache the same way.

The port compiles no executable per phase.  ``compile_counts()`` (and the
``serve_jit_executables{phase=...}`` gauge) counts what ``jax.jit``'s cache
holds one executable for: the distinct argument signatures each phase has
run (``serve_step.Executables``), the reference's counts on the same
requests and the set one CUDA graph per phase would capture.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import set_mesh
from repro_torch.models.model import decode_step, init_cache, insert_cache, prefill_step
from repro_torch.models.parallel import is_dtensor
from repro_torch.obs import MFUMeter, Registry, get_tracer, using
from .serve_step import Executables, SamplingConfig, make_decode_step, new_cache, sample_logits


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
        spec=None,  # Optional[repro_torch.spec.SpecConfig]: speculative decoding
        draft_params=None,  # draft model params (self-draft reuses `params`)
        registry: Optional[Registry] = None,  # repro_torch.obs metrics sink
        tracer=None,  # repro_torch.obs Tracer (default: ambient, usually Null)
        device="cuda",
        mesh=None,  # torch DeviceMesh over ("data", "model"); None: one device
    ):
        if cfg.family == "encoder":
            raise ValueError("encoder archs have no decode phase")
        self.cfg, self.params, self.mesh = cfg, params, mesh
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
        self._generator = torch.Generator(device=self.device).manual_seed(self.sampling.seed)
        self._decode = make_decode_step(cfg, sampling=self.sampling)
        self._executables = Executables()

        # -- telemetry: an engine-scoped registry, so that two engines (a
        # spec target and a vanilla baseline) never share counters; the
        # tracer defaults to the ambient one, the free NullTracer unless a
        # launcher installed a real Tracer.
        self.registry = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.mfu = MFUMeter(cfg, self.registry)
        self._stat_keys = ["prefill_calls", "insert_calls", "decode_steps"]
        self._counters = {
            k: self.registry.counter(f"serve_{k}_total", h)
            for k, h in [
                ("prefill_calls", "prefill calls"),
                ("insert_calls", "cache-insert calls"),
                ("decode_steps", "batched generate steps"),
            ]
        }
        self._tokens_total = self.registry.counter(
            "serve_tokens_total", "tokens emitted across all requests"
        )
        self._requests_total = self.registry.counter(
            "serve_requests_completed_total", "requests retired"
        )
        self._h_ttft = self.registry.histogram("serve_ttft_seconds", "submit -> first token")
        self._h_tpot = self.registry.histogram(
            "serve_tpot_seconds", "per-token latency of batched decode steps"
        )
        self._h_queue = self.registry.histogram("serve_queue_wait_seconds", "submit -> prefill start")
        self._h_prefill = self.registry.histogram("serve_prefill_seconds", "prefill + insert wall time")
        self._h_batch_util = self.registry.histogram(
            "serve_batch_utilization", "live slots / batch per generate step",
            buckets=tuple(np.round(np.arange(0.05, 1.05, 0.05), 2)),
        )
        self._g_occupancy = self.registry.gauge("serve_slot_occupancy", "fraction of decode slots live")
        self._g_queue_depth = self.registry.gauge("serve_queue_depth", "requests waiting for a slot")
        self._g_compiled = self.registry.gauge(
            "serve_jit_executables", "argument signatures per engine phase (compiled executables in the reference)",
            ("phase",),
        )

        # -- speculative decoding: draft worker + verify closure --
        self.spec = spec
        self.draft = None
        if spec is not None:
            # Imported here: repro_torch.spec imports repro_torch.serve.serve_step,
            # so a module-level import would be circular.
            from repro_torch.spec import DraftWorker, make_spec_verify, resolve_draft_config

            if not self.sampling.greedy:
                raise ValueError(
                    "speculative decoding requires greedy sampling "
                    "(lossless greedy acceptance)"
                )
            self.draft_cfg = resolve_draft_config(spec, cfg)
            if draft_params is None:
                if spec.draft_arch is not None:
                    raise ValueError(
                        "draft_params is required when draft_arch names a "
                        "distinct model"
                    )
                draft_params = params  # self-draft
            self.draft = DraftWorker(
                self.draft_cfg, draft_params, batch_size=batch_size, max_len=max_len,
                prefill_chunk=prefill_chunk, device=self.device,
                mesh=mesh if is_dtensor(draft_params["embed"]) else None,
            )
            self._verify = make_spec_verify(cfg)
            spec_keys = [
                ("verify_steps", "wide verify forwards"),
                ("draft_steps", "draft decode steps"),
                ("proposed_tokens", "draft tokens proposed"),
                ("accepted_tokens", "draft tokens the target accepted"),
            ]
            self._stat_keys += [k for k, _ in spec_keys]
            self._counters.update(
                {k: self.registry.counter(f"serve_{k}_total", h) for k, h in spec_keys}
            )
            self._g_acceptance = self.registry.gauge(
                "spec_acceptance_rate",
                "cumulative fraction of proposed draft tokens accepted",
            )

    # -- introspection ------------------------------------------------------

    @property
    def stats(self) -> dict:
        """The ``serve_*_total`` counters as a fresh plain dict."""
        return {k: int(self._counters[k].value) for k in self._stat_keys}

    def compile_counts(self) -> dict:
        """Argument signatures run so far, per phase (also exported as the
        ``serve_jit_executables`` gauge)."""
        phases = ("prefill", "insert", "generate") + (("verify",) if self.draft is not None else ())
        counts = self._executables.counts(phases)
        if self.draft is not None:
            counts.update(self.draft.compile_counts())
        for phase, n in counts.items():
            self._g_compiled.labels(phase=phase).set(n)
        return counts

    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        proposed = self._counters["proposed_tokens"].value if self.draft else 0
        return self._counters["accepted_tokens"].value / proposed if proposed else 0.0

    # -- request intake -----------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the largest prefill "
                f"bucket {self.buckets[-1]}"
            )
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        self._g_queue_depth.set(len(self.queue))

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
        req.t_prefill = t0 = time.perf_counter()
        with self.tracer.span(
            "prefill", cat="serve", tid=slot,
            args={"rid": req.rid, "len": plen, "bucket": bucket},
        ):
            tokens = torch.as_tensor(toks, device=self.device)
            self._executables.see("prefill", tokens)
            prefix = self._new_cache(1, bucket)
            logits, prefix = prefill_step(self.params, self.cfg, tokens, prefix, [plen],
                                          chunk_size=self.prefill_chunk)
            tok0 = sample_logits(logits[0, plen - 1], self._generator, self.sampling)
            self._executables.see("insert", self.cache, prefix)
            self.cache = insert_cache(self.cache, prefix, slot)
            tok0 = int(tok0)  # waits for the device: the first token is on the host
        # The first token is sampled inside prefill, so TTFT is the queue
        # wait plus the prefill span.
        req.t_first_token = req.t_last_token = now = time.perf_counter()
        self._counters["prefill_calls"].inc()
        self._counters["insert_calls"].inc()
        self._tokens_total.inc()
        self._h_prefill.observe(now - t0)
        self._h_queue.observe(t0 - req.t_submit)
        self._h_ttft.observe(now - req.t_submit)
        self.mfu.prefill(plen, now - t0)
        self._g_queue_depth.set(len(self.queue))
        self._positions[slot] = plen
        self._next_tok[slot] = tok0
        return tok0

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        self._done.append(req)
        self.slots[slot] = None
        self._finish(req, slot)

    def _finish(self, req: Request, slot: int) -> None:
        """Close out a request's telemetry: the completion counter and the
        retroactive queued and decode spans on the slot's trace lane."""
        self._requests_total.inc()
        tr = self.tracer
        if req.t_submit is not None and req.t_prefill is not None:
            tr.complete_abs("queued", req.t_submit, req.t_prefill, cat="request",
                            tid=slot, args={"rid": req.rid})
        if req.t_first_token is not None and req.t_last_token is not None:
            n = len(req.output)
            tr.complete_abs("decode", req.t_first_token, req.t_last_token, cat="request",
                            tid=slot, args={"rid": req.rid, "tokens": n})
            tr.instant("retire", tid=slot, args={"rid": req.rid, "tokens": n})

    def _new_cache(self, batch: int, max_len: int):
        return new_cache(self.cfg, batch, max_len, self.device, self.mesh)

    @torch.no_grad()
    def step(self) -> bool:
        """Back-fill free slots, then advance every live slot one token.

        Returns True while work remains (live slots or queued requests).
        The engine's tracer is the ambient one inside the step, so the
        model's device spans reach it; they are flushed at the step's end,
        where the device has already caught up with the host's last read.
        """
        with set_mesh(self.mesh), using(self.tracer):
            more = self._step()
        self.tracer.flush()
        return more

    def _step(self) -> bool:
        if self.cache is None:
            self.cache = self._new_cache(self.batch, self.max_len)
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
                    self._finish(req, i)
                else:
                    self.slots[i] = req
                    if self.draft is not None:
                        # Mirror the insert into the draft's slot pool so
                        # its context matches the target's from round one.
                        self.draft.prefill_into_slot(req.prompt, i, self.bucket_for(len(req.prompt)))

        live = [i for i in range(self.batch) if self.slots[i] is not None]
        self._g_occupancy.set(len(live) / self.batch)
        self._g_queue_depth.set(len(self.queue))
        if not live:
            return bool(self.queue)
        self._h_batch_util.observe(len(live) / self.batch)
        if self.draft is not None:
            self._spec_generate(live)
        else:
            self._generate(live)
        return bool(self.queue or any(r is not None for r in self.slots))

    def _generate(self, live: list) -> None:
        """Vanilla generate: one batched decode step, one token per slot."""
        t0 = time.perf_counter()
        with self.tracer.span("generate", cat="serve", tid=0, args={"live": len(live)}):
            tokens = torch.as_tensor(self._next_tok[:, None], device=self.device)
            positions = torch.as_tensor(self._positions, device=self.device)
            self._executables.see("generate", self.cache, tokens, positions)
            with self.tracer.span("decode_step", args={"live": len(live)}, device=True):
                nt, _logits, self.cache = self._decode(self.params, self.cache, tokens, positions, self._generator)
            nt = nt[:, 0].cpu().numpy()  # waits for the decode result
        now = time.perf_counter()
        self._counters["decode_steps"].inc()
        self._tokens_total.inc(len(live))
        # One batched step emits one token per live slot, so the step's wall
        # time is each slot's per-token latency this round.
        self._h_tpot.observe(now - t0)
        self.mfu.decode(self._positions[live], now - t0)

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

    def _spec_generate(self, live: list) -> None:
        """Speculative generate: K+1 draft steps and one wide verify pass.

        Emits between 1 and K+1 tokens per live slot.  The emitted tokens
        are the target's own greedy continuation (``repro_torch.spec.verify``),
        so the output stream equals ``_generate``'s: speculation changes the
        step count, never the tokens.
        """
        k = self.spec.lookahead
        t0 = time.perf_counter()
        with self.tracer.span("draft", cat="serve", tid=0, args={"k": k}):
            drafts = self.draft.propose(self._next_tok, k)  # [B, K]
        tokens = np.concatenate([self._next_tok[:, None], drafts], axis=1).astype(np.int32)
        t1 = time.perf_counter()
        with self.tracer.span("verify", cat="serve", tid=0, args={"live": len(live), "k": k}):
            tokens = torch.as_tensor(tokens, device=self.device)
            positions = torch.as_tensor(self._positions, device=self.device)
            self._executables.see("verify", self.cache, tokens, positions)
            greedy, accepted, self.cache = self._verify(self.params, self.cache, tokens, positions)
            # One read for both: the round's only wait on the verify.
            both = torch.cat([greedy, accepted[:, None]], dim=1).cpu().numpy()
            greedy, accepted = both[:, :-1], both[:, -1]
        now = time.perf_counter()
        self._counters["verify_steps"].inc()
        self._counters["draft_steps"].inc(k + 1)
        self.mfu.verify(self._positions[live], k, now - t1)
        # Per-token latency of the round: the draft+verify wall time over the
        # tokens it emitted (an upper bound: early retirement can drop some).
        emitted = int(np.sum(accepted[live] + 1))
        self._h_tpot.observe((now - t0) / max(emitted, 1))

        # Post-verify lengths (``accepted`` is already capped to the cache's
        # capacity); the draft mirrors them, so both caches hold exactly the
        # accepted prefix next round.
        new_lengths = self._positions + accepted + 1
        for i in live:
            req = self.slots[i]
            req.t_last_token = now
            pos0 = int(self._positions[i])
            n = int(accepted[i])
            self._counters["proposed_tokens"].inc(k)
            self._counters["accepted_tokens"].inc(n)
            # Consume the emitted run token by token, applying the
            # retirement rules (EOS / max_new_tokens / capacity) at the
            # points vanilla decode would.
            for j in range(n + 1):
                tok = int(greedy[i, j])
                req.output.append(tok)
                self._tokens_total.inc()
                self._positions[i] = pos0 + j + 1
                if (
                    tok == req.eos_id
                    or len(req.output) >= req.max_new_tokens
                    or pos0 + j + 1 >= self.max_len
                ):
                    self._retire(i)
                    break
            else:
                self._next_tok[i] = int(greedy[i, n])
        self._g_acceptance.set(self.acceptance_rate())
        self.draft.rollback(new_lengths)

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drain the queue; returns completed requests."""
        steps = 0
        while steps < max_steps:
            steps += 1
            if not self.step():
                break
        self.compile_counts()  # refresh the serve_jit_executables gauge
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
