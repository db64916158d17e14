"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

  1. device  — a CUDA card must be present; its name and power limit
               (nvidia-smi) and the torch/CUDA versions.
  2. build   — nvcc builds every kernel of the serving path from the
               sources in this checkout (sm_90a).
  3. kernels — each kernel against its plain PyTorch version on the card
               over a sweep (fp32/bf16, causal or not, GQA, ragged S,
               q_offset > 0, exact/PWL exp2, LSE, a strided KV cache), then
               timed at the serving path's shapes beside the plain version,
               F.scaled_dot_product_attention (a yardstick only; the port
               never calls it) and the card's bound.
  4. serve   — full-width olmo-1b in bf16 with seeded random weights served
               by ServeEngine, unchunked and with prefill_chunk=512; the
               kernels' launch counts are reset before and read after, and
               must equal one launch per layer per prefill chunk.  One
               request's prefill logits are held against the naive-attention
               path on the card.
  5. greedy  — the same model in fp32: the engine's greedy tokens must equal
               sequential_greedy_decode's, or the reference's top two logits
               at the first difference must lie within 1e-3 (a near-tie).

The last lines are the card's name and power limit, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.pwl_exp2 import LOG2_E  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.models.model import decode_step, init_cache, init_params, prefill_step  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    ServeEngine,
    request_latencies,
    sequential_greedy_decode,
)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version on the same inputs, as (atol, rtol).  fp32: only
# the order of the fp32 sums differs (the JAX tests' 3e-5).  bf16: both
# compute in fp32 and round the output to bf16 once, so two results whose
# fp32 values straddle a rounding boundary differ by one bf16 step, at most
# 2**-7 of the value; 1e-3 covers outputs near zero.
TOL = {torch.float32: (3e-5, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}
TOL_LSE = 1e-4
# The plain version runs at the kernel's tiling: with the PWL exp2 the LSE
# depends on where the k tiles break (see kernel.py).
TILE = flash.KERNEL_BLOCK
# Prefill logits, kernel path vs naive path, both bf16: relative to the
# largest logit.  Each of the 16 layers rounds the residual stream to bf16
# (2**-9 relative) a few times; 5e-2 is ~25 such roundings.
TOL_PREFILL_REL = 5e-2
NEAR_TIE = 1e-3


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` (L2 left warm, as the
    serving path leaves it: each layer's Q/K/V were just written)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# -- phase 3: kernels ---------------------------------------------------------

# (B, Sq, Sk, H, Hkv, d, causal, q_offset, dtype, exp2, lse, kv capacity)
SWEEP = [
    (1, 128, 128, 1, 1, 64, False, 0, torch.float32, "exact", False, None),
    (2, 256, 256, 4, 2, 64, True, 0, torch.float32, "exact", True, None),
    (1, 256, 512, 4, 1, 128, True, 256, torch.float32, "exact", True, None),
    (1, 100, 200, 4, 4, 32, True, 100, torch.float32, "pwl", True, None),
    (2, 64, 64, 8, 2, 16, False, 0, torch.bfloat16, "exact", False, None),
    (1, 512, 512, 16, 16, 128, True, 0, torch.bfloat16, "pwl", True, None),
    (1, 300, 812, 16, 16, 128, True, 512, torch.bfloat16, "exact", True, None),
    (2, 200, 700, 4, 2, 64, True, 500, torch.float32, "pwl", False, 1024),
    (1, 2048, 2048, 16, 16, 128, True, 0, torch.bfloat16, "exact", True, None),
]


def _flash_inputs(case, gen):
    b, sq, sk, h, hkv, d, causal, q_offset, dtype, exp2, lse, capacity = case
    q = _randn((b, sq, h, d), gen, dtype)
    if capacity is None:
        k = _randn((b, sk, hkv, d), gen, dtype)
        v = _randn((b, sk, hkv, d), gen, dtype)
    else:  # a prefix of a KV cache: batch stride capacity * Hkv * d
        k = _randn((b, capacity, hkv, d), gen, dtype)[:, :sk]
        v = _randn((b, capacity, hkv, d), gen, dtype)[:, :sk]
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset,
              exp2_impl=exp2, num_segments=8, return_lse=lse)
    return q, k, v, kw


def _max_err(a, b, dtype):
    """Largest |a - b|, and the largest share of its tolerance an element
    uses (above 1: the check fails)."""
    atol, rtol = TOL[dtype]
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), float((err / (atol + rtol * b.abs())).max())


def check_flash_sweep() -> float:
    """Largest |kernel - plain| over the sweep."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for case in SWEEP:
        q, k, v, kw = _flash_inputs(case, gen)
        out = flash.flash_attention_fwd(q, k, v, **kw)
        ref = flash.flash_attention_fwd_plain(q, k, v, block_q=TILE, block_k=TILE, **kw)
        torch.cuda.synchronize()
        if kw["return_lse"]:
            (out, lse), (ref, lse_ref) = out, ref
            lse_err = float((lse - lse_ref).abs().max())
            if not lse_err <= TOL_LSE:
                raise AssertionError(f"LSE mismatch {lse_err} > {TOL_LSE} for {case}")
        err, used = _max_err(out, ref, q.dtype)
        emit("kernels", case=str(case[:8] + (str(case[8]), case[9], case[10], case[11])),
             max_abs_err=err, tol=TOL[q.dtype], tol_used=used)
        if not used <= 1.0 or not torch.isfinite(out.float()).all():
            raise AssertionError(f"flash_fwd vs plain mismatch ({err}) for {case}")
        worst = max(worst, err)
    return worst


def check_pwl_subnormal_range() -> None:
    """PWL exp2 inside the kernel vs the plain version where the reference's
    result underflows: x = c * s_1 in about [-152, -118], read back exactly.

    Row r has keys s_0 = 0 (the max, v = 0) and s_1 = a_r < 0 (v = 2**100),
    so O[r, 0] = pwl(c * a_r) * 2**100 / l with l = 1 + pwl(c * a_r) = 1,
    and the product by a power of two is exact."""
    d, rows = 16, 4096
    c = LOG2_E / math.sqrt(d)
    a = torch.linspace(-152.0, -118.0, rows, device="cuda") / c
    q = torch.zeros((1, rows, 1, d), device="cuda")
    q[0, :, 0, 1] = a
    k = torch.zeros((1, 2, 1, d), device="cuda")
    k[0, 1, 0, 1] = 1.0
    v = torch.zeros((1, 2, 1, d), device="cuda")
    v[0, 1, 0, :] = 2.0 ** 100
    kw = dict(causal=False, scale=1.0 / math.sqrt(d), q_offset=0,
              exp2_impl="pwl", num_segments=8, return_lse=False)
    out = flash.flash_attention_fwd(q, k, v, **kw)
    ref = flash.flash_attention_fwd_plain(q, k, v, block_q=TILE, block_k=TILE, **kw)
    torch.cuda.synchronize()
    differ = int((out != ref).sum())
    nonzero = int((ref[0, :, 0, 0] != 0).sum())
    emit("kernels", check="pwl_subnormal_range", rows=rows, rows_differing=differ,
         nonzero_rows=nonzero)
    if differ:
        raise AssertionError(f"PWL exp2 differs from the plain version on {differ} rows")


def _attention_cost(b, s, h, d, itemsize):
    pairs = s * (s + 1) // 2  # causal: what this run's rows see
    flops = 4 * d * pairs * h * b
    nbytes = 4 * b * s * h * d * itemsize  # q, k, v read once; o written once
    return flops, nbytes


def time_flash() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for s in (512, 2048):
        b, h, d, dtype = 1, 16, 128, torch.bfloat16
        q, k, v = (_randn((b, s, h, d), gen, dtype) for _ in range(3))
        kw = dict(causal=True, scale=1.0 / math.sqrt(d), q_offset=0,
                  exp2_impl="exact", num_segments=8, return_lse=False)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: flash.flash_attention_fwd_plain(
            q, k, v, block_q=TILE, block_k=TILE, **kw))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        flops, nbytes = _attention_cost(b, s, h, d, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        row = dict(shape=[b, s, h, d], dtype="bfloat16", causal=True,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops, bytes=nbytes)
        emit("kernels", timing=row)
        rows.append(row)
    return rows


# -- phase 4: serve -------------------------------------------------------------

SERVE_PROMPT_LENS = (64, 1536, 200, 700, 96, 1100, 400, 1400)
MAX_NEW = 16


def _expected_launches(engine: ServeEngine, prompts, cfg) -> int:
    total = 0
    for p in prompts:
        bucket = engine.bucket_for(len(p))
        chunk = min(engine.prefill_chunk or bucket, bucket)
        total += cfg.num_layers * -(-bucket // chunk)
    return total


def serve(cfg, params) -> dict:
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    # Warm-up (not counted, not timed): CUDA context, cuBLAS handles, the
    # kernel's library load.
    warm = ServeEngine(cfg, params, batch_size=4, max_len=2048, device="cuda")
    warm.submit(Request(rid=-1, prompt=prompts[0], max_new_tokens=2))
    warm.run()

    runs, launches, outputs = [], 0, {}
    for chunk in (None, 512):
        engine = ServeEngine(cfg, params, batch_size=4, max_len=2048,
                             prefill_chunk=chunk, device="cuda")
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        flash.launch_count = 0
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run_launches = flash.launch_count
        expected = _expected_launches(engine, prompts, cfg)
        if run_launches != expected:
            raise AssertionError(
                f"flash_fwd launched {run_launches} times, expected {expected} "
                f"(prefill_chunk={chunk})"
            )
        if len(done) != len(prompts) or any(len(r.output) != MAX_NEW for r in done):
            raise AssertionError(f"engine finished {len(done)} requests, not all with {MAX_NEW} tokens")
        launches += run_launches
        outputs[chunk] = {r.rid: r.output for r in done}
        ttft, tpot = request_latencies(done)
        toks = sum(len(r.output) for r in done)
        run = dict(prefill_chunk=chunk, requests=len(done), tokens=toks, seconds=dt,
                   tokens_per_s=toks / dt, ttft_ms_p50=float(np.median(ttft)) * 1e3,
                   prefill_ms_p50=float(np.median(
                       [r.t_first_token - r.t_prefill for r in done])) * 1e3,
                   tpot_ms_p50=float(np.median(tpot)) * 1e3,
                   flash_launches=run_launches, stats=engine.stats)
        emit("serve", **run)
        runs.append(run)
    same = sum(outputs[None][i] == outputs[512][i] for i in outputs[None])
    emit("serve", chunked_equals_unchunked=f"{same}/{len(prompts)} requests")

    # One request's prefill logits: kernel path vs naive-attention path.
    p = prompts[3]
    bucket = 1024
    toks = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    toks[0, :len(p)] = torch.as_tensor(p, device="cuda")
    with torch.no_grad():
        got, _ = prefill_step(params, cfg, toks, init_cache(cfg, 1, bucket, "cuda"), [len(p)])
        naive_cfg = dataclasses.replace(cfg, attention_impl="naive")
        ref, _ = prefill_step(params, naive_cfg, toks, init_cache(cfg, 1, bucket, "cuda"), [len(p)])
    got, ref = got[0, :len(p)].float(), ref[0, :len(p)].float()
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    emit("serve", prefill_logits_vs_naive=dict(prompt_len=len(p), max_rel_err=rel,
                                               tol=TOL_PREFILL_REL, argmax_agreement=agree))
    if not (rel <= TOL_PREFILL_REL and torch.isfinite(got).all()):
        raise AssertionError(f"prefill logits differ from the naive path: {rel}")
    return dict(runs=runs, launches=launches)


# -- phase 5: greedy equivalence in fp32 ------------------------------------------

GREEDY_PROMPT_LENS = (37, 130, 256)


def _reference_top2_gap(cfg, params, tokens) -> float:
    """Top-1 minus top-2 logit of sequential decode after ``tokens``."""
    cache = init_cache(cfg, 1, len(tokens), "cuda")
    for i, t in enumerate(tokens):
        logits, cache = decode_step(params, cfg, torch.tensor([[int(t)]], device="cuda"), cache, i)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def greedy(cfg) -> dict:
    params = init_params(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in GREEDY_PROMPT_LENS]
    engine = ServeEngine(cfg, params, batch_size=2, max_len=512, device="cuda")
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    done = {r.rid: r.output for r in engine.run()}
    near_ties = 0
    with torch.no_grad():
        for i, p in enumerate(prompts):
            ref = sequential_greedy_decode(cfg, params, p, MAX_NEW, max_len=512)
            if done[i] == ref:
                continue
            t = next(j for j, (a, b) in enumerate(zip(done[i], ref)) if a != b)
            gap = _reference_top2_gap(cfg, params, np.concatenate([p, ref[:t]]))
            emit("greedy", rid=i, first_difference=t, reference_top2_gap=gap)
            if gap > NEAR_TIE:
                raise AssertionError(f"request {i}: engine {done[i]} != sequential {ref}")
            near_ties += 1
    emit("greedy", requests=len(prompts), tokens_each=MAX_NEW, near_ties=near_ties,
         identical=len(prompts) - near_ties)
    return dict(near_ties=near_ties)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        sys.exit(1)
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [
        line.strip() for path in libs.values()
        for line in path.with_suffix(".log").read_text().splitlines()
        if "registers" in line or "spill" in line
    ]
    emit("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in libs.values()],
         ptxas=ptxas)

    sweep_err = check_flash_sweep()
    check_pwl_subnormal_range()
    timing = time_flash()

    cfg = get_config("olmo-1b")
    params = init_params(cfg, seed=0, device="cuda")
    served = serve(cfg, params)
    del params
    torch.cuda.empty_cache()
    greedy(dataclasses.replace(cfg, dtype="float32"))

    main_shape = timing[-1]
    record = dict(
        name="flash_fwd", route="cuda", source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:64",
        launches=served["launches"], max_abs_err=sweep_err,
        tol={"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16]},
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"], shape=main_shape["shape"], by_shape=timing,
    )
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
