"""Where the serving path's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch qwen3-moe-235b-a22b --layers 4 --quant int8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch zamba2-1.2b

Runs a full-width model (default olmo-1b; ``--layers`` cuts its depth,
``--quant`` sets an int8 policy) in bf16 with seeded random weights at the
shapes of ``chip_smoke.py``'s serve phase and, for each of the two serving
phases,
takes the host wall time of the phase (median of ``REPEATS`` runs, each
ended by a synchronize) and one ``torch.profiler`` trace of it:

  * prefill — ``prefill_step`` of one ``PROMPT_LEN``-token request filling a
    ``BUCKET`` cache (what TTFT pays once per request, less the queue wait);
    the recurrent families (zamba2, xlstm) teacher-force a bucket through
    ``decode_step``, one step a token, so theirs is ``SCAN_PROMPT_LEN`` in
    ``SCAN_BUCKET`` (chip_smoke.py's recurrent phase's 40-token request);
  * decode  — ``STEPS`` batched ``decode_step`` calls of ``BATCH`` slots at
    depth ``DEPTH`` in a ``MAX_LEN`` cache (what TPOT pays; recurrent
    states start at zero).

Each phase prints one JSON line: wall ms, device (kernel) ms from the
trace, the device's busy share of the wall time, the kernels that take the
most device time, and the device ms inside each profiler range of the MoE
layer (dispatch, expert products, combine) and of the int8 products
(quantization, ``_int_mm``), with the MoE dispatches and ``_int_mm`` calls
per call.  Needs the card.  ``launch/profile_train.py``
reports a training step with the same helpers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.models import decode_step, init_cache, init_params, prefill_step
from repro_torch.models import moe
from repro_torch.quant import QUANT_FLAGS
from repro_torch.quant import quantize

BUCKET, PROMPT_LEN = 2048, 1536  # the serve phase's longest prompt, its bucket
SCAN_BUCKET, SCAN_PROMPT_LEN = 64, 40  # recurrent families: one decode step a bucket token
BATCH, MAX_LEN, DEPTH = 4, 2048, 1024  # its engine's slots and cache, half full
STEPS = 10  # decode steps per timed call
REPEATS = 5
TOP = 12  # kernels listed per phase
# The forward kernels, by a substring of their names (kernel.KERNELS picks
# one): the tensor-core kernel for bf16 at d 64 and 128, the SIMT one else.
FORWARD_GROUPS = {"flash_fwd_sm90": "flash_fwd_sm90_kernel", "flash_fwd_simt": "flash_fwd_kernel"}
RANGES = moe.RANGES + quantize.RANGES


def _wall_ms(fn) -> float:
    fn()  # warm-up: library handles, kernel build and load
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _kernels(fn) -> tuple[float, list[dict], dict]:
    """Device ms of one traced call of ``fn`` and all its kernels, the one
    that takes the most device time first, and the device ms of the kernels
    launched inside each of ``RANGES``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # A range also shows on the device's timeline (its span, gaps and
    # all); only kernels count here.
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and e.key not in RANGES
    ]
    ranges = {name: 0.0 for name in RANGES}
    for e in prof.events():
        if e.name in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.name] += e.device_time_total / 1e3
    total = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return total, [
        {"kernel": name, "ms": ms, "share": ms / total if total else 0.0, "calls": n}
        for name, ms, n in rows
    ], ranges


def report(phase: str, fn, calls: int, groups=None, **extra) -> None:
    """One JSON line for ``fn``, which makes ``calls`` calls of the phase;
    times are per call.  ``groups`` maps a label to a substring of kernel
    names; the line gives each group's share of the device time."""
    wall = _wall_ms(fn) / calls
    moe.reset_counts()
    quantize.reset_counts()
    device_ms, rows, ranges = _kernels(fn)
    device_ms /= calls
    moe_calls = {mode: moe.counts[mode] / calls for mode in ("capacity", "dropless")}
    shares = {
        label: sum(r["share"] for r in rows if part in r["kernel"])
        for label, part in (groups or {}).items()
    }
    top_rows = [
        {**r, "kernel": r["kernel"][:90], "ms": r["ms"] / calls, "calls": r["calls"] // calls}
        for r in rows[:TOP]
    ]
    print(json.dumps({
        "phase": phase, **extra, "wall_ms_per_call": wall,
        "device_ms_per_call": device_ms, "device_busy_share": device_ms / wall,
        **({"group_shares": shares} if groups else {}),
        "range_device_ms_per_call": {name: ms / calls for name, ms in ranges.items()},
        "moe_calls_per_call": moe_calls, "int_mm_calls_per_call": quantize.int_mm_calls / calls,
        "top_kernels": top_rows,
    }), flush=True)


def _at_depth(cache, depth: int):
    """The cache with every slot's KV length set to ``depth``."""
    if isinstance(cache, dict):
        return {name: _at_depth(part, depth) for name, part in cache.items()}
    if hasattr(cache, "lengths"):
        return cache._replace(lengths=torch.full_like(cache.lengths, depth))
    return cache  # recurrent state


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: the config's)")
    ap.add_argument("--quant", default="none", choices=QUANT_FLAGS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card; no CUDA device found")

    cfg = get_config(args.arch, args.quant)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "arch": cfg.name, "layers": cfg.num_layers,
                      "quant": args.quant, "dtype": cfg.dtype}), flush=True)

    recurrent = cfg.family in ("hybrid", "ssm")
    bucket, prompt_len = (SCAN_BUCKET, SCAN_PROMPT_LEN) if recurrent else (BUCKET, PROMPT_LEN)
    tokens = torch.randint(0, cfg.vocab_size, (1, bucket), generator=gen, device="cuda")

    def prefill():
        cache = init_cache(cfg, 1, bucket, "cuda")
        prefill_step(params, cfg, tokens, cache, [prompt_len])

    report("prefill", prefill, 1, groups=FORWARD_GROUPS, bucket=bucket, prompt_len=prompt_len)

    cache = _at_depth(init_cache(cfg, BATCH, MAX_LEN, "cuda"), DEPTH)
    step_tokens = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen, device="cuda")
    positions = torch.full((BATCH,), DEPTH, dtype=torch.int32, device="cuda")

    def decode():
        # Every step writes row DEPTH again, so the cache stays as it is.
        for _ in range(STEPS):
            decode_step(params, cfg, step_tokens, cache, positions)

    report("decode", decode, STEPS, batch=BATCH, depth=DEPTH, max_len=MAX_LEN)


if __name__ == "__main__":
    main()
