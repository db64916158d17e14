"""Serving launcher: continuous batching against a (smoke-config) model,
counterpart of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --check
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --check --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --check --device cpu

Requests get mixed prompt lengths (the engine buckets them for prefill),
arrive all at once, and drain through a fixed slot pool, so this drives
prefill bucketing, slot eviction and back-fill even in a smoke run.  The
weights are random, from ``--seed``.

  --temperature/--top-k/--top-p  sampling policy (default greedy)
  --chunk N                      chunked flash prefill (N tokens per call;
                                 the recurrent families zamba2-1.2b and
                                 xlstm-125m prefill by teacher-forcing and
                                 ignore it)
  --quant int8                   int8 projections + int8 KV cache
                                 (repro_torch.quant; greedy outputs stay
                                 token-equal to sequential decode)
  --spec-draft self|ARCH         speculative decoding (repro_torch.spec):
                                 'self' drafts with the target itself
                                 (acceptance 1.0); an arch id drafts with
                                 that smoke config (random weights from
                                 --seed + 1)
  --spec-k N                     lookahead: draft tokens verified per round
  --spec-quant int8              int8 policy on the draft only
  --check                        verify every greedy output token-for-token
                                 against sequential single-request decode
  --metrics-out PATH             dump the engine's metrics registry as
                                 Prometheus text at exit (TTFT/TPOT/queue
                                 histograms, occupancy and MFU gauges, and
                                 jit_compiles_total: the kernel libraries
                                 nvcc built during the run)
  --trace-out PATH               save a Chrome-trace/Perfetto JSON of the run
  --device                       cuda (default) or cpu
  --mesh DxM                     shard params + decode cache over a debug
                                 mesh (data x model), e.g. --mesh 2x2;
                                 D*M > 1 runs under torchrun (gloo with
                                 --device cpu, NCCL on the card), --mesh 1x1
                                 makes a world-size-1 group; it combines
                                 with --spec-draft (the draft of a
                                 self-draft shares the placed params)

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --spec-draft self --spec-quant int8 --check
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch yi-9b --check --device cpu --mesh 2x2
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch olmo-1b --check --device cpu --mesh 2x2 \
      --spec-draft self --spec-quant int8

The run line ends with ``compiles {...}``: the engine's argument signatures
per phase (``ServeEngine.compile_counts``).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import init_params
from repro_torch.obs import Tracer, set_tracer, watch_jit_compiles
from repro_torch.quant.config import QUANT_FLAGS
from repro_torch.serve import (
    Request,
    SamplingConfig,
    ServeEngine,
    request_latencies,
    sequential_greedy_decode,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="max prompt length; actual lengths are mixed in [2, N]")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--quant", default="none", choices=QUANT_FLAGS,
                    help="int8 quantization policy (repro_torch.quant)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec-draft", default=None,
                    help="speculative decoding draft: 'self' or an arch id")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative lookahead (draft tokens per round)")
    ap.add_argument("--spec-quant", default="none", choices=QUANT_FLAGS,
                    help="int8 policy applied to the draft model only")
    ap.add_argument("--check", action="store_true",
                    help="compare against sequential single-request decode")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write Prometheus text exposition here at exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh", default=None, help="debug mesh DxM, e.g. 2x2")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch, args.quant)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch: no decode phase")

    params = plain_params = init_params(cfg, args.seed, device=args.device)
    mesh = None
    if args.mesh:
        from repro_torch.dist.sharding import param_shardings, place
        from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh, parse_mesh

        data, model = parse_mesh(args.mesh)
        if ensure_process_group(data * model, args.device):
            import atexit

            import torch.distributed as dist

            atexit.register(dist.destroy_process_group)
        mesh = make_debug_mesh(data, model, device_type=args.device)
        params = place(params, param_shardings(params, cfg, mesh))
    sampling = SamplingConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed,
    )

    spec = draft_params = None
    if args.spec_draft:
        from repro_torch.spec import SpecConfig, resolve_draft_config

        spec = SpecConfig(
            draft_arch=None if args.spec_draft == "self" else args.spec_draft,
            draft_quant=args.spec_quant if args.spec_quant != "none" else None,
            lookahead=args.spec_k,
        )
        if spec.draft_arch is not None:
            # Random weights: the draft->verify->rollback path runs in full
            # (outputs stay lossless; only the acceptance rate suffers).
            draft_params = init_params(resolve_draft_config(spec, cfg), args.seed + 1, device=args.device)

    tracer = None
    if args.trace_out:
        tracer = Tracer(process_name=f"serve {args.arch}")
        set_tracer(tracer)

    engine = ServeEngine(
        cfg, params, batch_size=args.batch, max_len=args.max_len,
        prefill_chunk=args.chunk, sampling=sampling, spec=spec,
        draft_params=draft_params, tracer=tracer, device=args.device, mesh=mesh,
    )

    rng = np.random.default_rng(0)
    prompts = {}
    for i in range(args.requests):
        plen = int(rng.integers(2, max(3, args.prompt_len + 1)))
        prompts[i] = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=args.max_new))

    # With a metrics sink requested, also count the kernel libraries built
    # during the run into the registry (one log record a build).
    compile_watch = (
        watch_jit_compiles(engine.registry.counter("jit_compiles_total", "kernel library builds observed"))
        if args.metrics_out else contextlib.nullcontext()
    )
    t0 = time.perf_counter()
    with compile_watch:
        done = engine.run()
    dt = time.perf_counter() - t0

    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(prompts[r.rid])}] -> {r.output}")
    toks = sum(len(r.output) for r in done)
    print(
        f"completed {len(done)}/{args.requests} on {args.device}: {toks} tokens "
        f"in {dt:.2f}s ({toks / dt:.1f} tok/s) | stats {engine.stats} "
        f"| compiles {engine.compile_counts()}"
    )
    if spec is not None:
        print(
            f"spec: acceptance {engine.acceptance_rate():.3f} | "
            f"{engine.stats['verify_steps']} verify steps for {toks} tokens "
            f"({toks / max(engine.stats['verify_steps'], 1):.2f} tok/verify)"
        )
    ttft, tpot = request_latencies(done)
    print(
        f"latency: ttft p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | "
        f"tpot p50 {np.percentile(tpot, 50) * 1e3:.1f} ms"
        if tpot else f"latency: ttft p50 {np.percentile(ttft, 50) * 1e3:.1f} ms"
    )
    if args.metrics_out:
        engine.registry.dump(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace ({len(tracer.events)} events) -> {args.trace_out}")

    if args.check:
        if not sampling.greedy:
            raise SystemExit("--check requires greedy decoding (temperature 0)")
        bad = 0
        for r in sorted(done, key=lambda r: r.rid):
            ref = sequential_greedy_decode(
                cfg, plain_params, prompts[r.rid], args.max_new, max_len=args.max_len
            )
            if r.output != ref:
                bad += 1
                print(f"MISMATCH req {r.rid}: engine {r.output} != ref {ref}")
        if bad:
            raise SystemExit(f"{bad}/{len(done)} requests diverged")
        print(f"check OK: all {len(done)} outputs match sequential decode")


if __name__ == "__main__":
    main()
