"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines of output each (any failure raises and exits
non-zero):

  1. device  — a CUDA card must be present; its name and power limit
               (nvidia-smi) and the torch/CUDA versions.
  2. build   — nvcc builds every kernel (forward and backward) from the
               sources in this checkout (sm_90a), one process per source.
  3. kernels — the forward kernel against its plain PyTorch version on the
               card over a sweep (fp32/bf16, causal or not, GQA, ragged S,
               q_offset > 0, exact/PWL exp2, LSE, a strided KV cache), then
               timed at the serving and training shapes beside the plain
               version, F.scaled_dot_product_attention (a yardstick only;
               the port never calls it) and the card's bound.
  4. kernels_bwd — the dQ and dK/dV kernels against the plain FA-2 version
               over a sweep (fp32/bf16, causal or not, GQA rep 2 and 4,
               ragged S, q_offset > 0, an LSE from a PWL forward, d 16 to
               128, the training shape), then timed at the training shape
               beside the plain version, SDPA's backward and the bound.
  5. serve   — full-width olmo-1b in bf16 with seeded random weights served
               by ServeEngine, unchunked and with prefill_chunk=512; the
               kernels' launch counts are reset before and read after, and
               must equal one launch per layer per prefill chunk.  One
               request's prefill logits are held against the naive-attention
               path on the card.
  6. greedy  — the same model in fp32: the engine's greedy tokens must equal
               sequential_greedy_decode's, or the reference's top two logits
               at the first difference must lie within 1e-3 (a near-tie).
  7. train   — full-width olmo-1b in bf16 (remat, AdamW, cosine schedule)
               trained by the port's Trainer for 6 steps at batch 4 x 2048
               of SyntheticLM(seed=0); the launch counts are reset before
               and read after (forward: layers x 2 x steps, with the remat
               recompute; dQ and dK/dV: layers x steps); the loss must be
               finite at every step and lower at the last than at the first.
  8. grads   — one batch's gradients at full width and depth 2, kernel path
               against the naive-attention path, in fp32 and in bf16.

The last lines are the card's name and power limit, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.pwl_exp2 import LOG2_E  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd  # noqa: E402
from repro_torch.models.model import decode_step, init_cache, init_params, prefill_step  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    ServeEngine,
    request_latencies,
    sequential_greedy_decode,
)
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

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


def _max_err(a, b, dtype, tol=TOL):
    """Largest |a - b|, and the largest share of its tolerance an element
    uses (above 1: the check fails)."""
    atol, rtol = tol[dtype]
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


def _bound(flops, nbytes):
    """The least time the card could take, in ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def time_flash() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    # Serving prefill (B = 1, no LSE), then training (B = 4, LSE for the
    # backward); the plain version is slow, so the last takes 3 timings.
    for b, s, lse, plain_iters in ((1, 512, False, 20), (1, 2048, False, 20), (4, 2048, True, 3)):
        h, d, dtype = 16, 128, torch.bfloat16
        q, k, v = (_randn((b, s, h, d), gen, dtype) for _ in range(3))
        kw = dict(causal=True, scale=1.0 / math.sqrt(d), q_offset=0,
                  exp2_impl="exact", num_segments=8, return_lse=lse)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: flash.flash_attention_fwd_plain(
            q, k, v, block_q=TILE, block_k=TILE, **kw), iters=plain_iters, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        flops, nbytes = _attention_cost(b, s, h, d, 2)
        nbytes += b * h * s * 4 if lse else 0
        bound_ms, bound_by = _bound(flops, nbytes)
        row = dict(shape=[b, s, h, d], dtype="bfloat16", causal=True, lse=lse,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
        emit("kernels", timing=row)
        rows.append(row)
    return rows


# -- phase 4: backward kernels -----------------------------------------------------

# Backward kernels vs the plain version on the same inputs, as (atol, rtol).
# fp32: only the order of the fp32 sums differs, over up to Sq * rep terms
# for dK and dV (3200 here), so a little above the forward's 3e-5.  bf16:
# both compute in fp32 and round each gradient to bf16 once: one bf16
# step, as the forward's TOL, with 1e-3 for values near zero.
TOL_BWD = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}

# (B, Sq, Sk, H, Hkv, d, causal, q_offset, dtype, exp2 of the forward)
BWD_SWEEP = [
    (1, 128, 128, 1, 1, 64, False, 0, torch.float32, "exact"),
    (2, 256, 256, 4, 2, 64, True, 0, torch.float32, "exact"),
    (1, 256, 512, 4, 1, 128, True, 256, torch.float32, "exact"),
    (1, 100, 200, 4, 4, 32, True, 100, torch.float32, "pwl"),
    (2, 200, 700, 4, 2, 64, True, 500, torch.float32, "pwl"),
    (2, 64, 64, 8, 2, 16, False, 0, torch.bfloat16, "exact"),
    (1, 77, 130, 8, 4, 32, False, 0, torch.bfloat16, "exact"),
    (1, 300, 812, 16, 16, 128, True, 512, torch.bfloat16, "exact"),
    (1, 512, 512, 16, 16, 128, True, 0, torch.bfloat16, "pwl"),
    (4, 2048, 2048, 16, 16, 128, True, 0, torch.bfloat16, "exact"),  # training shape
]


def _bwd_inputs(case, gen):
    """q, k, v, the forward's output and LSE (from the kernel), dO."""
    b, sq, sk, h, hkv, d, causal, q_offset, dtype, exp2 = case
    q = _randn((b, sq, h, d), gen, dtype)
    k, v = (_randn((b, sk, hkv, d), gen, dtype) for _ in range(2))
    do = _randn((b, sq, h, d), gen, dtype)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset)
    out, lse = flash.flash_attention_fwd(q, k, v, exp2_impl=exp2, num_segments=8,
                                         return_lse=True, **kw)
    return (q, k, v, out, lse, do), kw


def check_bwd_sweep() -> dict:
    """Largest |kernel - plain| of dQ, and of dK and dV, over the sweep."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"dq": 0.0, "dkv": 0.0}
    for case in BWD_SWEEP:
        args, kw = _bwd_inputs(case, gen)
        got = flash_bwd.flash_attention_bwd(*args, **kw)
        ref = flash_bwd.flash_attention_bwd_plain(*args, block_q=TILE, block_k=TILE, **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            err, used = _max_err(g, r, case[8], TOL_BWD)
            errs[name] = dict(max_abs_err=err, tol_used=used)
            if not used <= 1.0 or not torch.isfinite(g.float()).all():
                raise AssertionError(f"flash_bwd {name} vs plain mismatch ({err}, tol_used {used}) for {case}")
        worst["dq"] = max(worst["dq"], errs["dq"]["max_abs_err"])
        worst["dkv"] = max(worst["dkv"], errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])
        emit("kernels_bwd", case=str(case[:8] + (str(case[8]), case[9])),
             tol=TOL_BWD[case[8]], **errs)
    return worst


def _bwd_cost(b, s, h, hkv, d, itemsize, products, q_sized, kv_sized):
    """Operations of ``products`` d-deep products per causal pair and head;
    bytes of ``q_sized`` [B, S, H, d] and ``kv_sized`` [B, S, Hkv, d] tensors
    in the inputs' dtype and of LSE and delta (fp32), each read or written
    once."""
    pairs = s * (s + 1) // 2
    flops = 2 * products * d * pairs * h * b
    nbytes = (q_sized * b * s * h + kv_sized * b * s * hkv) * d * itemsize + 2 * b * h * s * 4
    return flops, nbytes


def time_bwd() -> dict:
    """The backward at the training shape: each kernel alone, the whole
    (delta + dQ + dK/dV), the plain version and SDPA's backward."""
    case = BWD_SWEEP[-1]
    b, s, _, h, hkv, d = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(3)
    (q, k, v, out, lse, do), kw = _bwd_inputs(case, gen)
    whole_ms = cuda_ms(lambda: flash_bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    plain_ms = cuda_ms(lambda: flash_bwd.flash_attention_bwd_plain(
        q, k, v, out, lse, do, block_q=TILE, block_k=TILE, **kw), iters=3, warmup=1)

    # Each kernel alone, on the wrapper's buffers.
    lib = flash_bwd._library()
    delta = torch.empty((b * h, s), dtype=torch.float32, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (flash._DTYPE_CODES[q.dtype], b, h, hkv, s, s, d)
    c, stream = kw["scale"] * LOG2_E, torch.cuda.current_stream().cuda_stream
    extra = (0, True, c, kw["scale"], stream)
    dq_ms = cuda_ms(lambda: flash_bwd._launch_dq(lib, q, k, v, out, do, lse, delta, dq, common, *extra))
    dkv_ms = cuda_ms(lambda: flash_bwd._launch_dkv(lib, q, k, v, do, lse, delta, dk, dv, common, *extra))

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))

    rows = {}
    # dQ: S, dP, dQ from q, k, v, o, dO, LSE into dQ and delta.  dK/dV: S,
    # dP, dV, dK from q, k, v, dO, LSE, delta.  Whole: five products (S and
    # dP once), q, k, v, o, dO, LSE, delta in and dQ, dK, dV out.
    work = (("dq", dq_ms, (3, 4, 2)), ("dkv", dkv_ms, (4, 2, 4)), ("whole", whole_ms, (5, 4, 4)))
    for name, ms, (products, q_sized, kv_sized) in work:
        flops, nbytes = _bwd_cost(b, s, h, hkv, d, 2, products, q_sized, kv_sized)
        bound_ms, bound_by = _bound(flops, nbytes)
        rows[name] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes)
    timing = dict(shape=[b, s, h, d], dtype="bfloat16", causal=True, plain_ms=plain_ms,
                  library_ms=sdpa_ms, **rows)
    emit("kernels_bwd", timing=timing)
    return timing


# -- phase 5: serve -------------------------------------------------------------

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


# -- phase 6: greedy equivalence in fp32 ------------------------------------------

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


# -- phase 7: train --------------------------------------------------------------

TRAIN_SHAPE = ShapeConfig("chip_smoke", 2048, 4, "train")  # seq 2048, batch 4
TRAIN_STEPS = 6
# The reference's peak lr, 3e-4, reached after 2 warm-up steps (not its
# default 10): the params are bf16 with no fp32 master copy, so an update
# much below half a bf16 step of a weight (~6e-5 at the init's ~0.02)
# rounds away.  A peak of 1e-3 made the loss climb from 10.1 to 16.2 at
# full width before it fell again.
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2


def train(cfg) -> dict:
    """The port's Trainer on full-width olmo-1b; launch counts of the run."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1, ckpt_dir=ckpt_dir,
                             peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, log_every=1, seed=0)
        trainer = Trainer(cfg, TRAIN_SHAPE, tcfg, device="cuda")
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.launch_count = flash_bwd.dq_launch_count = flash_bwd.dkv_launch_count = 0
        state = trainer.run(state)
        torch.cuda.synchronize()
        launches = dict(flash_fwd=flash.launch_count, flash_bwd_dq=flash_bwd.dq_launch_count,
                        flash_bwd_dkv=flash_bwd.dkv_launch_count)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = state["losses"]
    steps = list(trainer.watchdog.durations)
    tokens = TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len
    step_s = float(np.median(steps[1:]))  # the first step also warms up
    expected = dict(flash_fwd=cfg.num_layers * 2 * TRAIN_STEPS,
                    flash_bwd_dq=cfg.num_layers * TRAIN_STEPS,
                    flash_bwd_dkv=cfg.num_layers * TRAIN_STEPS)
    emit("train", arch=cfg.name, dtype=cfg.dtype, remat=cfg.remat, batch=TRAIN_SHAPE.global_batch,
         seq=TRAIN_SHAPE.seq_len, losses=losses, step_seconds=steps, step_s_median=step_s,
         tokens_per_s=tokens / step_s, max_memory_allocated_gb=peak_gb,
         launches=launches, expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"training launched {launches}, expected {expected}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite at every step: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return dict(launches=launches, step_s=step_s, tokens_per_s=tokens / step_s, losses=losses)


# -- phase 8: gradients, kernel path vs naive path ---------------------------------

GRADS_DEPTH, GRADS_BATCH, GRADS_SEQ = 2, 2, 1024
# Each leaf's max |kernel - naive| over its max |naive|.  fp32: the two paths
# round attention differently (~1e-6 of the largest gradient when this
# comparison runs on the CPU at depth 1); 1e-4 leaves two orders for the
# sums of a card.  bf16: activations and gradients round to bf16 at every
# layer, and the naive path's gradients of q, k, v are rounded from other
# fp32 values than the kernel's (~8e-3 on the CPU at depth 1); 5e-2 is ~6
# bf16 steps (2**-7) of the largest gradient.
TOL_GRADS = {"float32": 1e-4, "bfloat16": 5e-2}


def grads(cfg) -> dict:
    worst = {}
    for dtype, tol in TOL_GRADS.items():
        small = dataclasses.replace(cfg, num_layers=GRADS_DEPTH, dtype=dtype)
        params = init_params(small, seed=2, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        toks = torch.randint(0, small.vocab_size, (GRADS_BATCH, GRADS_SEQ + 1), generator=gen, device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        loss, got = value_and_grad(small, params, batch)
        ref_loss, ref = value_and_grad(dataclasses.replace(small, attention_impl="naive"), params, batch)
        rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                  for a, b in zip(tree_leaves(got), tree_leaves(ref)))
        emit("grads", dtype=dtype, depth=GRADS_DEPTH, batch=GRADS_BATCH, seq=GRADS_SEQ,
             loss=float(loss), naive_loss=float(ref_loss), max_rel_err=rel, tol=tol)
        if not rel <= tol or not math.isfinite(float(loss)):
            raise AssertionError(f"{dtype} gradients differ from the naive path: {rel} > {tol}")
        worst[dtype] = rel
        del params, got, ref
        torch.cuda.empty_cache()
    return worst


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
    bwd_err = check_bwd_sweep()
    bwd_timing = time_bwd()

    cfg = get_config("olmo-1b")
    params = init_params(cfg, seed=0, device="cuda")
    served = serve(cfg, params)
    del params
    torch.cuda.empty_cache()
    greedy(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.empty_cache()
    trained = train(cfg)
    torch.cuda.empty_cache()
    grads(cfg)

    serve_shape = next(r for r in timing if r["shape"] == [1, 2048, 16, 128])
    fwd_launches = dict(serve=served["launches"], train=trained["launches"]["flash_fwd"])
    records = [dict(
        name="flash_fwd", route="cuda", source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:64",
        launches=sum(fwd_launches.values()), launches_by_path=fwd_launches, max_abs_err=sweep_err,
        tol={"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16]},
        ms=serve_shape["ms"], plain_ms=serve_shape["plain_ms"],
        bound_ms=serve_shape["bound_ms"], bound_by=serve_shape["bound_by"],
        library_ms=serve_shape["library_ms"], shape=serve_shape["shape"], by_shape=timing,
    )]
    # Each backward kernel is timed alone; the plain version and SDPA's
    # backward compute dQ, dK and dV together, so theirs are the whole's.
    for name, key, line in (("flash_bwd_dq", "dq", 48), ("flash_bwd_dkv", "dkv", 81)):
        row = bwd_timing[key]
        records.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/flash_bwd.cu",
            replaces=f"src/repro/kernels/flash_attention/kernel_bwd.py:{line}",
            launches=trained["launches"][name], launches_by_path=dict(train=trained["launches"][name]),
            max_abs_err=bwd_err[key],
            tol={"float32": TOL_BWD[torch.float32], "bfloat16": TOL_BWD[torch.bfloat16]},
            ms=row["ms"], plain_ms=bwd_timing["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=bwd_timing["library_ms"],
            shape=bwd_timing["shape"], whole_backward=bwd_timing["whole"],
        ))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
