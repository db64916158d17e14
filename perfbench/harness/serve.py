"""A serving run: ``repro_torch.serve.engine.ServeEngine`` fed through
``submit`` and stepped by this loop.

Set-up makes the weights from the seed, builds the engine, and warms up
each prefill bucket that the mix's prompts can reach (one request of that
bucket, decoded one step), so every shape the window uses has run once.
Then traffic starts: an open loop submits each request when it is due, a
closed loop keeps ``clients`` requests in the system, each client sending
its next the moment its last finishes.  After ``ramp_s`` seconds of traffic
the window opens; it closes ``--seconds`` later, and the loop goes on
stepping (and sending) until every request due in the window has its first
token, a minute at the most.  A traced run then profiles ``trace_s``
seconds of the same traffic right after the window: starting and stopping
the profiler takes seconds, which would stall the window's requests.

After each ``step`` the loop reads each live request's ``output``: a new
first token takes the engine's ``t_first_token``, a new decoded token its
``t_last_token``, both taken after the device's result reached the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs import NullTracer, Tracer
from repro_torch.serve import Request, SamplingConfig, ServeEngine

from . import bench, check, generate, profiling, weights
from .record import Req, Run

DRAIN_S = 60.0


def warm_buckets(traffic: dict) -> list[int]:
    """The prefill buckets that prompts of the mix can land in."""
    lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
    buckets = sorted(traffic["engine"]["prefill_buckets"])
    used, prev = [], 0
    for b in buckets:
        if b >= lo and prev < hi:
            used.append(b)
        prev = b
    return used


def bucket_for(traffic: dict, plen: int) -> int:
    return next(b for b in sorted(traffic["engine"]["prefill_buckets"]) if plen <= b)


def _warm_up(engine: ServeEngine, traffic: dict, vocab: int) -> None:
    rng = np.random.default_rng(0)
    lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
    for i, b in enumerate(warm_buckets(traffic)):
        n = max(min(b, hi), lo)
        engine.submit(Request(rid=-1 - i, prompt=rng.integers(1, vocab, n), max_new_tokens=2))
    engine.run()
    profiling.sync()


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device, t_process: float):
    tr, eng = cell.traffic, cell.traffic["engine"]
    cfg = bench.model_config(cell.model)
    params = weights.make(cell.model, seed, device)
    tracer = Tracer(process_name="perfbench") if trace else NullTracer()
    engine = ServeEngine(
        cfg, params, batch_size=eng["batch_size"], max_len=eng["max_len"],
        prefill_buckets=tuple(eng["prefill_buckets"]), sampling=SamplingConfig(),
        tracer=tracer, device=device,
    )
    _warm_up(engine, tr, cfg.vocab_size)

    stream = generate.Requests(tr, cfg.vocab_size, seed)
    records: list[Req] = []
    live: list[Req] = []

    def submit(due: float):
        prompt, max_new, gap = stream.next()
        req = Request(rid=len(records), prompt=prompt, max_new_tokens=max_new)
        rec = Req(due=due, prompt_len=len(prompt), max_new=max_new, engine_req=req)
        engine.submit(req)
        records.append(rec)
        live.append(rec)
        return gap

    capture = profiling.Capture() if trace else None
    t_traffic = time.perf_counter()
    w_open = t_traffic + tr["ramp_s"]
    w_close = w_open + seconds
    open_loop = tr["loop"] == "open"
    next_due = t_traffic
    if not open_loop:
        for _ in range(tr["clients"]):
            submit(t_traffic)

    while True:
        now = time.perf_counter()
        if open_loop:
            while next_due <= now:
                next_due += submit(next_due)
        if capture is not None:
            if capture.prof is None and now >= w_close:
                capture.start()
            elif capture.running and now >= capture.t0 + tr["trace_s"]:
                capture.stop()
        if engine.queue or any(s is not None for s in engine.slots):
            engine.step()
        elif open_loop:
            time.sleep(max(0.0, min(next_due - time.perf_counter(), 0.002)))
        t = time.perf_counter()
        still = []
        for rec in live:
            req = rec.engine_req
            n, seen = len(req.output), len(rec.token_times)
            if n > seen:
                if seen == 0:
                    rec.t_prefill = req.t_prefill
                    rec.token_times.append(req.t_first_token)
                    seen = 1
                rec.token_times.extend([req.t_last_token] * (n - seen))
            if req.done:
                rec.done = True
                if not open_loop:
                    submit(t)
            else:
                still.append(rec)
        live = still
        if t >= w_close:
            waiting = any(not r.token_times for r in records if w_open <= r.due < w_close)
            traced = capture is None or capture.t1 is not None
            if (not waiting and traced) or t >= w_close + DRAIN_S:
                break
    if capture is not None and capture.running:
        capture.stop()
    profiling.sync()
    run = Run(kind="serve", model=cell.model, traffic=tr, window=(w_open, w_close), setup_s=w_open - t_process,
              requests=records)
    if trace:
        run.trace = capture.reduce() if capture.t0 is not None else None
        run.trace_t0, run.trace_t1 = capture.t0, capture.t1
        epoch = tracer._epoch
        run.spans = [(e["name"], epoch + e["ts"] / 1e6, epoch + (e["ts"] + e["dur"]) / 1e6, e.get("args", {}))
                     for e in tracer.events if e.get("ph") == "X"]
    memory_peak = torch.cuda.max_memory_allocated(device) if engine.device.type == "cuda" else 0

    # The output check, once the program's state is freed.
    samples = _sample(records, tr, seed)
    missing = sum(1 for r in run.due_in_window() if not r.token_times)
    short = sum(1 for p, out, want in samples if len(out) != want)
    engine.cache = None
    del engine
    profiling.free()
    run.samples = [(p, out) for p, out, _ in samples]
    numbers = check.served_logit_gaps(params, cell.model, run.samples, lambda n: bucket_for(tr, n))
    numbers.update(missing_first_tokens=missing, short_outputs=short,
                   unchecked_samples=tr["check"]["requests"] - len(samples))
    for rec in records:
        rec.engine_req = None
    return run, numbers, memory_peak, len(run.due_in_window()), missing


def _sample(records: list, traffic: dict, seed: int) -> list:
    """The finished requests the output check reads: the longest, and others
    drawn from the seed.  Each as (prompt, served tokens, tokens asked)."""
    done = [r for r in records if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: r.prompt_len + len(r.engine_req.output))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(seed % 2**63)
    k = min(traffic["check"]["requests"] - 1, len(rest))
    picked = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), size=k, replace=False))]
    max_len = traffic["engine"]["max_len"]
    return [(r.engine_req.prompt.copy(), np.asarray(r.engine_req.output, np.int64),
             min(r.max_new, max_len - r.prompt_len + 1)) for r in picked]
