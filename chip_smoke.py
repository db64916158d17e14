"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines of output each (any failure raises and exits
non-zero):

  1. device  — a CUDA card must be present; its name and power limit
               (nvidia-smi) and the torch/CUDA versions.
  2. build   — nvcc builds every kernel (the two forwards, the two
               backward pairs, PWL exp2) from the sources in this checkout
               (sm_90a), one process per source, all started together;
               ptxas's registers and spills of each tensor-core
               instantiation (none may spill; the forward's d = 64 spills,
               on zamba2's main path, are printed on their own), of each SIMT forward
               instantiation (flash_fwd_kernel<T, D, BQ>) and of each SIMT
               backward instantiation (flash_bwd_dq_kernel and
               flash_bwd_dkv_kernel<T, D, R>: per dtype, d and resident
               tile), none of which may spill; the SIMT backward's CTAs an
               SM by the occupancy API.
  3. kernels — the forward kernels against their plain PyTorch version on
               the card over a sweep (fp32/bf16, d 16 to 128, causal or not,
               GQA, ragged Sq and Sk (Sq 1, 17, 33 around the SIMT kernel's
               16- and 32-row q tiles), q_offset > 0, exact/PWL exp2 with K 8
               and 4, LSE, a strided KV cache, B up to 4, and the main
               path's training, chunked-prefill, fp32 greedy-prefill and
               fp32 gradient-check shapes, GQA rep 16, qwen3-moe's 64
               q heads over 4 kv heads, in bf16 and fp32, and zamba2's 32
               heads of 64 at its training and gradient-check shapes); the kernel that
               takes each case (kernel.KERNELS: "sm90" for bf16 at d 64 and
               128, "simt" otherwise) is held against the plain version that
               rounds P as it does, and the sm90 kernel also against the
               fp32-P plain version within the bound of P's rounding
               (TOL_FP32P, element by element).  Then the sm90
               kernel is timed at the serving and training shapes and at
               qwen3-moe's 2048-token prefill (rep 16) and zamba2's
               training shape ([4, 2048, 32, 64], d 64 at olmo's work), and the
               simt kernel at the fp32 greedy phase's two prefill buckets,
               the largest fp32 serving bucket and the gradient check's
               forward (with LSE), in event and device time, beside the
               plain version, F.scaled_dot_product_attention (a yardstick
               only; the port never calls it; the profiler names the CUDA
               kernel it launched) and the card's bound; and at the greedy
               buckets with the q tile that simt_q_tile did not choose.
  4. kernels_bwd — the dQ and dK/dV kernels against the plain FA-2 version
               over a sweep (fp32/bf16, causal or not, GQA rep 2 and 4,
               ragged Sq and Sk (Sq 1, 17, 33 around the simt pair's
               tiles), q_offset > 0, an LSE from a PWL forward, B = 3, d 16
               to 128, the training shape, the simt pair at its timed
               shapes, and rep 16 in bf16 and fp32); the pair that takes
               each case
               (kernel_bwd.BWD_KERNELS: "sm90" for bf16 at d 64 and 128,
               "simt" otherwise) must launch once per kernel and is held
               against the plain version that rounds P and dS as it does
               (the simt pair's dQ at its q tile and dK/dV at its k tile,
               kernel_bwd.simt_bwd_tiles; the sm90 pair with the bound of
               roundings that fall apart, TOL_BWD_FLIPS), and the sm90 pair
               also against the fp32-P plain version within the bound of
               that rounding (TOL_BWD_FP32P beside
               kernel_bwd.departure_bound, element by element).  Then the
               sm90 pair is timed at the training shape, at rep 16
               ([1, 2048, 64/4, 128]: dK/dV gets 4 kv heads' CTAs) and at
               zamba2's training shape ([4, 2048, 32, 64], the same work at
               d 64; a line sets d 64 beside d 128), the
               simt pair
               at [1, 256], [2, 1024] (the fp32 gradient check's shape) and
               [1, 2048], fp32 causal, 16 heads of 128: each kernel alone
               and the whole, in event and device time (each kernel's share
               of the whole from the profiler), beside the plain version,
               SDPA's backward and the bound; and the simt pair at [1, 256]
               with each resident tile.
  5. kernels_pwl — the standalone PWL exp2 kernel against its plain version,
               bit for bit, in fp32, bf16 and fp16 for K in {2, ..., 64}
               (inputs down to the fp32 underflow, 0, -0, -inf, NaN; a
               ragged length, a strided view, an empty tensor), then timed
               at 2**26 fp32 elements and at the tune path's 30,720 beside
               the plain version, torch.exp2 (a bandwidth reference; no
               PyTorch call computes the PWL) and the bound.
 5b. kernels_decode — the decode-attention kernel against its plain version
               (the reference's masked einsums over the cache widened to
               fp32) in fp32 before the cast, within 2e-6 of each case's
               largest output: chat's cache (128 slots of 2048, 16 KV heads
               of 128, bf16), qwen3-moe's rep 16 at S 1 and 5, zamba2's d
               64, reps 7 and 8, d 16, 80 and 192, fp32 and bf16, lengths
               of 0, max_len - 1, max_len and past it; one launch a call.
               Then timed at chat's shape with every slot full and with
               chat-like lengths, in event and device time, beside its
               byte bound, the plain version and one masked
               F.scaled_dot_product_attention call (a yardstick only; the
               port never calls it).
  6. serve   — full-width olmo-1b in bf16 with seeded random weights served
               by ServeEngine, unchunked and with prefill_chunk=512; the
               kernels' launch counts are reset before and read after, and
               must equal one sm90 launch per layer per prefill chunk, and
               one decode-attention launch per layer per decode step.  One
               request's prefill logits are held against the naive-attention
               path on the card.
 12. spec    — (runs after serve, greedy and moe) speculative decoding
               (repro_torch.spec) and telemetry: the serve phase's engine and
               requests with SpecConfig(lookahead=4), self-draft and the int8
               draft, unchunked and chunked; every forward launch sm90 and
               exactly twice the serve phase's count (target and draft
               prefills); tokens/s, TTFT, TPOT (per request, and amortized
               over each round as the reference's histogram), verify and
               draft steps, acceptance, peak memory, requests equal to the
               vanilla run's.  The self-draft unchunked run is traced: the
               Chrome trace must hold one verify span a verify step and k + 1
               draft steps a draft span, and the registry's serve_*_total
               counters must equal engine.stats; its MFU gauges are printed
               (against the paper's FSA array, not the card).  fp32 gate
               (after greedy): the greedy phase's prompts and one of 508
               tokens (its first round writes past the 512-slot cache and
               drops a row), self-draft and int8 draft under "none" and
               self-draft under "int8-kv-only": tokens equal the vanilla
               engine's but at a near-tie (the greedy phase's rule); all
               prefills simt.  MoE (after moe): qwen3-moe at full width,
               depth 2, fp32, capacity_factor E / k, self-draft against the
               vanilla engine, every verify and draft MoE call dropless.
  7. greedy  — the same model in fp32: the engine's greedy tokens must equal
               sequential_greedy_decode's, or the reference's top two logits
               at the first difference must lie within 1e-3 (a near-tie);
               its prefills go through the simt kernel alone (counts reset
               before the engine runs, read after).
  8. train   — full-width olmo-1b in bf16 (remat, AdamW, cosine schedule)
               trained by the port's Trainer for 6 steps at batch 4 x 2048
               of SyntheticLM(seed=0); the launch counts are reset before
               and read after (forward, all sm90: layers x 2 x steps, with
               the remat recompute; dQ and dK/dV, all sm90: layers x steps);
               the loss must be finite at every step and lower at the last
               than at the first; its JSONL metrics stream must read back
               through launch/scrape_log.py with a finite loss at every
               step, and its MFU gauge is printed.
  9. grads   — one batch's gradients at full width and depth 2, kernel path
               against the naive-attention path, in fp32 (the simt
               backward pair) and in bf16 (the sm90 pair), one launch of
               each kernel of the pair per layer (counts reset before, read
               after).
 10. tune    — the FSA design-space autotuner (repro_torch.tune) on the
               card: the "paper" preset at the launcher's defaults and the
               "full" preset (320 points); the caches are cleared and the
               PWL kernel's launch count reset before, read after: one
               launch per distinct segment count (the Fig. 12 sweeps).  Both
               must pass their paper and simulator checks, and the paper
               point's Fig. 12 MRE must equal the plain CPU value.
 11. moe     — (runs before tune) the MoE and int8 slice: int8_dot and
               int8_dot_batched on the card at qwen3-moe's prefill and
               decode shapes against the CPU version, int32 accumulators
               and outputs bit for bit; qwen3-moe-235b-a22b at full width,
               depth 4, bf16: moe_forward twice bit-equal, then served as
               in phase 6 under --quant none and int8 (all prefill
               launches sm90 at GQA rep 16; MoE calls by mode, the share of
               copies dropped, _int_mm calls and peak memory per run;
               prefill logits against the naive path); depth 2 in fp32
               with capacity_factor E / k (nothing drops): greedy tokens
               equal to sequential decode, all simt; depth 1 in fp32,
               batch 1 x 512: gradients against the naive path (the simt
               forward and pair); arctic-480b at full width, depth 1, bf16:
               prefill logits against the naive path, then 4 decode steps
               (the dense residual).  Each model is freed before the next.

 13. recurrent — (runs after spec, before tune) the recurrent families at
               full width and depth with seeded random weights.  zamba2-1.2b
               (38 Mamba2 layers, one shared attention block of 32 heads of
               64 applied 7 times), bf16: served by ServeEngine(batch_size=2,
               max_len=256) with 4 requests of 16, 40, 100 and 200 tokens, 8
               new tokens each (tokens/s, TTFT, prefill, TPOT, peak memory;
               the prefill teacher-forces each bucket through decode_step, so
               no flash launch: gated at 0); forward on 1 x 2048: 7 sm90
               launches, each application's attention output within
               TOL_PREFILL_REL of the naive path's on the same input, the
               fp32 model's logits within TOL_GRADS of the naive path's
               (the bf16 model's reported: 38 bf16 layers carry a one-step
               difference on to them);
               trained as the train phase (4 x 2048, 6 steps, remat, AdamW):
               84 sm90 forward launches, 42 dQ and 42 dK/dV, a finite loss
               that falls; in fp32 at depth 7 (applications at layers 0 and
               6): greedy tokens equal to sequential decode (or a near-tie),
               decode logits within 5e-3 of forward's, gradients at 1 x 512
               within TOL_GRADS of the naive path (the simt forward and pair
               at d 64, 4 and 2 + 2 launches).  xlstm-125m (6 (mLSTM, sLSTM)
               pairs), bf16: served the same way (0 flash launches), trained
               6 steps of 2 x 256 (a finite, falling loss); in fp32 at full
               depth the greedy and decode-vs-forward gates.  The phase
               prints its seconds.

 14. dist    — (runs after recurrent, before tune) the distribution slice:
               a world-size-1 NCCL group and a 1 x 1 ("data", "model") mesh;
               the params placed as DTensors by the TP rules
               (repro_torch.dist.sharding; every placement fits to
               Replicate) and the model run through its islands
               (repro_torch.models.parallel).  Full-width olmo-1b in bf16
               served under the mesh with the serve phase's requests
               (unchunked): tokens equal to the serve phase's, the same sm90
               launches, TTFT/TPOT/tokens/s beside the serve phase's;
               trained 3 steps at the train phase's 4 x 2048: losses equal
               to the train phase's first 3 bit for bit, half its launches
               of each kernel, step times beside; qwen3-moe-235b-a22b at
               depth 4 under none served under the mesh (the expert-parallel
               branch at model = 1): tokens, MoE calls and launches equal to
               the moe phase's; the same under int8: tokens, sm90 launches
               and _int_mm calls equal to the moe phase's int8 run (at
               model = 1 no int8 product is split, so none reduces),
               TTFT/TPOT beside it.  int8 under a model axis > 1 (each
               product with the whole operands' scales and int32 sum over
               "model") runs only in gloo ranks on the CPU
               (tests/test_torch_dist_int8.py): one card has one rank.
               (a) The spec phase's self-draft run
               (unchunked) under the mesh, the draft sharing the placed
               params and placing its own cache: tokens, acceptance and
               sm90 launches equal to the no-mesh run's, TTFT/TPOT (per
               request and amortized)/tokens/s/peak beside it.  (b)
               compressed_pmean over the "data" group on the gradient of
               the first training step (its loss gated equal to that
               step's): average and new residual bit-equal to the int8
               round trip with n = 1, and its CUDA-event time.  (c)
               pipelined_apply over the 16 stacked layers, one
               _transformer_block a stage, on a [4, 2048] input: the mesh
               has no "pod" axis (one rank), so the sequential schedule,
               bit-equal to the layer loop with 16 sm90 launches; the
               pipelined schedule runs only in gloo ranks on the CPU.  (e)
               The serve and spec phases' and this phase's engines print
               compile_counts() and serve a second wave in the same
               buckets, which must leave them unchanged.  Then, the NCCL
               group destroyed, the dry-run on fake groups: lower_cell("olmo-1b", 4 x 2048, 1 x 1)
               (predicted t_compute, t_memory and bytes per device beside the
               train phase's step time and peak), and run_cell("olmo-1b",
               "train_4k") on the 16 x 16 production mesh.  The recurrent
               phase also serves zamba2-1.2b and xlstm-125m under int8 (one
               request each, _int_mm calls gated non-zero: the width
               padding of fault F1's repair).  The phase prints its seconds.

(d) A JitCompileWatcher (repro_torch.obs) counts from the start the kernel
libraries nvcc builds; the ``[builds]`` line prints them by phase, and no
phase after the build phase may build one.

The last lines are the card's name and power limit, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --time-simt

runs phases 1 and 2 and the simt kernels' timing alone (no checks beyond
the build, no result lines): the forward's, and the simt backward pair's
at its three shapes through its public entry (the whole, and each
kernel's device time from the profiler), so that one call can time two
checkouts of the kernels on one card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.pwl_exp2 import LOG2_E, fp16_negative_normals, pwl_error_stats  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_attn  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_source  # noqa: E402
from repro_torch.dist import batch_pspec, param_shardings, pipelined_apply, place, set_mesh  # noqa: E402
from repro_torch.dist.collectives import full  # noqa: E402
from repro_torch.kernels.pwl_exp2 import kernel as pwl  # noqa: E402
from repro_torch.launch import scrape_log  # noqa: E402
from repro_torch.launch.cells import lower_cell  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group, run_cell  # noqa: E402
from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh  # noqa: E402
from repro_torch.launch.roofline import analyze_trace  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import attention_forward  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402
from repro_torch.obs import JitCompileWatcher, Tracer  # noqa: E402
from repro_torch.models.model import _hybrid_layer, decode_step, forward, init_cache, init_params, prefill_step  # noqa: E402,E501
from repro_torch.models.model import _default_positions, _transformer_block, _unstack  # noqa: E402
from repro_torch.optim import compress_with_feedback, compressed_pmean, dequantize_int8, init_residual, quantize_int8  # noqa: E402,E501
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.quant import QUANT_FLAGS, int8_dot, int8_dot_batched, parse_quant, quantize  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    ServeEngine,
    request_latencies,
    sequential_greedy_decode,
)
from repro_torch.spec import SpecConfig  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tune import objectives as tune_objectives  # noqa: E402
from repro_torch.tune import run_tune  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# Kernel vs plain version on the same inputs, as (atol, rtol).  fp32: only
# the order of the fp32 sums differs (the JAX tests' 3e-5).  bf16: both
# compute in fp32 (the sm90 kernel and its plain twin both round P to bf16
# for PV) and round the output to bf16 once, so two results whose fp32
# values straddle a rounding boundary differ by one bf16 step, at most
# 2**-7 of the value; 1e-3 covers outputs near zero.
TOL = {torch.float32: (3e-5, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}
TOL_LSE = 1e-4
# The sm90 kernel vs the fp32-P plain version (the reference's numerics).
# o = sum_j p_j v_j / l with l = sum_j p_j from the fp32 P in both; rounding
# each p_j to bf16 moves it by at most 2**-8 of itself, so o moves by at
# most 2**-8 * sum_j p_j |v_j| / l, the fp32-P plain version's output on
# |v| (the "weighted |v|" of each element).  Each output is then rounded
# to bf16 (one step, 2**-7 of the value), and 1e-3 covers outputs near
# zero: |kernel - plain| <= 1e-3 + 2**-8 * weighted|v| + 2**-7 * |plain|.
TOL_FP32P = (1e-3, 2.0 ** -8, 2.0 ** -7)  # (atol, of weighted |v|, rtol)
# The plain version runs at the kernel's tiles (flash.fwd_tile): with the
# PWL exp2 the LSE depends on where the k tiles break (see kernel.py); the
# backward pairs have their own (flash_bwd.bwd_tile).
fwd_tile = flash.fwd_tile
bwd_tile = flash_bwd.bwd_tile
# Prefill logits, kernel path vs naive path, both bf16: relative to the
# largest logit.  Each of the 16 layers rounds the residual stream to bf16
# (2**-9 relative) a few times; 5e-2 is ~25 such roundings.
TOL_PREFILL_REL = 5e-2
NEAR_TIE = 1e-3
# A MoE model's routing near-tie: the reference path's smallest router
# margin (k-th minus (k+1)-th probability) before the first difference.  In
# fp32 the two paths' MoE inputs differ by the rounding of their sums, about
# 1e-6 of values of order 1 (an estimate), which moves a router probability
# of about 1/128 by about 1e-8; 1e-7 is ten times that.
ROUTER_NEAR_TIE = 1e-7
# The MFU gauges (repro_torch.obs.mfu) divide by the paper's FSA array, as
# the reference does, not by this card: on the H100 they can read above 1.
MFU_DENOMINATOR = "the paper's FSA array (N = 128 at 1.5 GHz, 49.15 TFLOP/s), not the H100"


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


def _device_events(fn, iters: int) -> list:
    """torch.profiler's CUDA events (``key_averages``) over ``iters`` calls
    of ``fn``, after one call outside the capture.  A capture now and then
    records no device event at all; it is then taken again, up to three
    times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.self_device_time_total for e in events) > 0:
            return events
    raise RuntimeError("torch.profiler recorded no device time in three captures")


def profiled(fn, iters: int = 20) -> tuple[float, list[str]]:
    """Device time of one call of ``fn``: every CUDA kernel and memset it
    launches over ``iters`` calls (torch.profiler), without the host's
    enqueue time that ``cuda_ms`` also sees when the card waits for it;
    and the names of the kernels it launched."""
    events = _device_events(fn, iters)
    return sum(e.self_device_time_total for e in events) / 1e3 / iters, sorted({e.key for e in events})


def profiled_ms(fn, iters: int = 20) -> float:
    return profiled(fn, iters)[0]


def profiled_by_kernel(fn, iters: int = 20) -> dict[str, float]:
    """Device time of one call of ``fn`` by CUDA kernel name (as ``profiled``)."""
    return {e.key: e.self_device_time_total / 1e3 / iters for e in _device_events(fn, iters)}


def reset_fwd_counts() -> None:
    for name in flash.launch_counts:
        flash.launch_counts[name] = 0


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# -- phase 3: kernels ---------------------------------------------------------

# (B, Sq, Sk, H, Hkv, d, causal, q_offset, dtype, exp2, PWL segments, lse,
# kv capacity)
SWEEP = [
    (1, 128, 128, 1, 1, 64, False, 0, torch.float32, "exact", 8, False, None),
    (2, 256, 256, 4, 2, 64, True, 0, torch.float32, "exact", 8, True, None),
    (1, 256, 512, 4, 1, 128, True, 256, torch.float32, "exact", 8, True, None),
    (1, 100, 200, 4, 4, 32, True, 100, torch.float32, "pwl", 8, True, None),
    (2, 64, 64, 8, 2, 16, False, 0, torch.bfloat16, "exact", 8, False, None),
    (1, 512, 512, 16, 16, 128, True, 0, torch.bfloat16, "pwl", 8, True, None),
    (1, 300, 812, 16, 16, 128, True, 512, torch.bfloat16, "exact", 8, True, None),
    (2, 200, 700, 4, 2, 64, True, 500, torch.float32, "pwl", 8, False, 1024),
    (1, 2048, 2048, 16, 16, 128, True, 0, torch.bfloat16, "exact", 8, True, None),
    # The sm90 kernel (bf16, d 64 and 128): d 64 with GQA rep 4; Sq and Sk
    # off the 128-row tile (1, 17, 200, 1000); q_offset off the tile; a KV
    # cache prefix; B = 3; the PWL at K 8 and 4 with LSE; not causal.
    (1, 256, 256, 8, 2, 64, True, 0, torch.bfloat16, "exact", 8, True, None),
    (2, 1, 17, 8, 2, 64, True, 16, torch.bfloat16, "exact", 8, True, None),
    (1, 17, 200, 4, 4, 128, True, 183, torch.bfloat16, "pwl", 4, True, None),
    (1, 200, 1000, 16, 16, 128, True, 800, torch.bfloat16, "exact", 8, True, None),
    (2, 300, 700, 8, 2, 128, True, 400, torch.bfloat16, "exact", 8, True, 1024),
    (3, 1000, 1000, 16, 16, 128, True, 0, torch.bfloat16, "pwl", 8, True, None),
    (1, 1000, 1000, 8, 2, 64, True, 0, torch.bfloat16, "pwl", 4, True, None),
    (2, 200, 1000, 4, 4, 128, False, 0, torch.bfloat16, "exact", 8, True, None),
    # The sm90 kernel at the main path's own shapes: the training shape with
    # LSE (1024 work tiles, ~8 per CTA of the persistent grid), and two
    # chunks of a 2048-token bucket with prefill_chunk=512 (q_offset 1024
    # and 1536: Sk 1536 and 2048 of a 2048-slot cache).
    (4, 2048, 2048, 16, 16, 128, True, 0, torch.bfloat16, "exact", 8, True, None),
    (1, 512, 1536, 16, 16, 128, True, 1024, torch.bfloat16, "exact", 8, True, 2048),
    (1, 512, 2048, 16, 16, 128, True, 1536, torch.bfloat16, "exact", 8, True, 2048),
    # The simt kernel (fp32; bf16 at d 16 and 32): Sq of 1, 17 and 33 around
    # its 16- and 32-row q tiles, with GQA, q_offset > 0, the PWL at K 4 and
    # 8 and LSE; then the fp32 greedy phase's two prefill buckets (a prefix
    # of its 512-slot cache) and the fp32 gradient check's forward.
    (1, 1, 130, 8, 4, 128, True, 129, torch.float32, "exact", 8, True, None),
    (2, 17, 17, 4, 2, 64, True, 0, torch.float32, "pwl", 4, True, None),
    (1, 17, 81, 8, 4, 16, True, 64, torch.bfloat16, "exact", 8, True, None),
    (1, 33, 33, 16, 16, 128, False, 0, torch.float32, "pwl", 8, True, None),
    (1, 33, 300, 4, 2, 32, True, 267, torch.bfloat16, "pwl", 8, True, None),
    (1, 64, 64, 16, 16, 128, True, 0, torch.float32, "exact", 8, False, 512),
    (1, 256, 256, 16, 16, 128, True, 0, torch.float32, "exact", 8, False, 512),
    (2, 1024, 1024, 16, 16, 128, True, 0, torch.float32, "exact", 8, True, None),
    # GQA rep 16 (qwen3-moe's 64 q heads over 4 kv heads): the sm90 kernel
    # in bf16 and the simt kernel in fp32.
    (1, 512, 512, 64, 4, 128, True, 0, torch.bfloat16, "exact", 8, True, None),
    (1, 256, 256, 64, 4, 128, True, 0, torch.float32, "exact", 8, True, None),
    # zamba2's shared attention, 32 heads of 64 (rep 1): its training shape
    # with LSE (sm90), a d-64 case off the tile with a q_offset, and the
    # fp32 gradient check's forward (simt).
    (4, 2048, 2048, 32, 32, 64, True, 0, torch.bfloat16, "exact", 8, True, None),
    (1, 300, 812, 32, 32, 64, True, 512, torch.bfloat16, "exact", 8, True, None),
    (1, 512, 512, 32, 32, 64, True, 0, torch.float32, "exact", 8, True, None),
]


def _flash_inputs(case, gen):
    b, sq, sk, h, hkv, d, causal, q_offset, dtype, exp2, segments, lse, capacity = case
    q = _randn((b, sq, h, d), gen, dtype)
    if capacity is None:
        k = _randn((b, sk, hkv, d), gen, dtype)
        v = _randn((b, sk, hkv, d), gen, dtype)
    else:  # a prefix of a KV cache: batch stride capacity * Hkv * d
        k = _randn((b, capacity, hkv, d), gen, dtype)[:, :sk]
        v = _randn((b, capacity, hkv, d), gen, dtype)[:, :sk]
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset,
              exp2_impl=exp2, num_segments=segments, return_lse=lse)
    return q, k, v, kw


def _max_err(a, b, dtype, tol=TOL):
    """Largest |a - b|, and the largest share of its tolerance an element
    uses (above 1: the check fails)."""
    atol, rtol = tol[dtype]
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), float((err / (atol + rtol * b.abs())).max())


def _fp32_p_err(out, ref, weighted_abs_v):
    """Largest |out - ref| and the largest share of TOL_FP32P it uses."""
    atol, of_v, rtol = TOL_FP32P
    err = (out.float() - ref.float()).abs()
    tol = atol + of_v * weighted_abs_v.float() + rtol * ref.float().abs()
    return float(err.max()), float((err / tol).max())


def check_flash_sweep() -> dict:
    """Largest |kernel - plain| over the sweep, by kernel (and, for sm90,
    against the fp32-P plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"sm90": 0.0, "simt": 0.0, "sm90_vs_fp32_p": 0.0}
    for case in SWEEP:
        q, k, v, kw = _flash_inputs(case, gen)
        kernel = flash.kernel_for(q.dtype, q.shape[-1]).name
        tile = fwd_tile(q.dtype, q.shape[-1])
        before = dict(flash.launch_counts)
        out = flash.flash_attention_fwd(q, k, v, **kw)
        plain = {"plain": flash.flash_attention_fwd_plain(q, k, v, block_q=tile, block_k=tile, **kw)}
        if kernel == "sm90":
            plain["fp32_p"] = flash.flash_attention_fwd_plain(
                q, k, v, block_q=tile, block_k=tile, fp32_p=True, **kw)
            weighted_abs_v = flash.flash_attention_fwd_plain(
                q, k, v.abs(), block_q=tile, block_k=tile, fp32_p=True, **dict(kw, return_lse=False))
        torch.cuda.synchronize()
        if flash.launch_counts[kernel] != before[kernel] + 1:
            raise AssertionError(f"{case} did not launch the {kernel} kernel: {flash.launch_counts}")
        fields = {}
        if kw["return_lse"]:
            out, lse = out
            for name, (_, lse_ref) in plain.items():
                lse_err = float((lse - lse_ref).abs().max())
                fields[f"lse_err_{name}"] = lse_err
                if not lse_err <= TOL_LSE:
                    raise AssertionError(f"LSE mismatch {lse_err} > {TOL_LSE} against {name} for {case}")
            plain = {name: ref for name, (ref, _) in plain.items()}
        err, used = _max_err(out, plain["plain"], q.dtype)
        fields.update(max_abs_err=err, tol=TOL[q.dtype], tol_used=used)
        if kernel == "sm90":
            err32, used32 = _fp32_p_err(out, plain["fp32_p"], weighted_abs_v)
            fields.update(max_abs_err_fp32_p=err32, tol_fp32_p=TOL_FP32P, tol_used_fp32_p=used32)
            worst["sm90_vs_fp32_p"] = max(worst["sm90_vs_fp32_p"], err32)
        emit("kernels", case=str(case[:8] + (str(case[8]),) + case[9:]), kernel=kernel, **fields)
        if not used <= 1.0 or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{kernel} forward vs plain mismatch ({err}) for {case}")
        if kernel == "sm90" and not used32 <= 1.0:
            raise AssertionError(f"sm90 forward vs fp32-P plain beyond TOL_FP32P ({err32}) for {case}")
        worst[kernel] = max(worst[kernel], err)
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
    tile = fwd_tile(q.dtype, d)
    ref = flash.flash_attention_fwd_plain(q, k, v, block_q=tile, block_k=tile, **kw)
    torch.cuda.synchronize()
    differ = int((out != ref).sum())
    nonzero = int((ref[0, :, 0, 0] != 0).sum())
    emit("kernels", check="pwl_subnormal_range", rows=rows, rows_differing=differ,
         nonzero_rows=nonzero)
    if differ:
        raise AssertionError(f"PWL exp2 differs from the plain version on {differ} rows")


def _attention_cost(b, s, h, d, itemsize, hkv=None):
    pairs = s * (s + 1) // 2  # causal: what this run's rows see
    flops = 4 * d * pairs * h * b
    nbytes = 2 * b * s * (h + (hkv or h)) * d * itemsize  # q, k, v read once; o written once
    return flops, nbytes


def _bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """The least time the card could take, in ms, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _time_forward(b, s, h, d, dtype, lse, plain_iters, gen, peak_flops, hkv=None):
    """One causal forward shape (``hkv`` kv heads, default ``h``): the
    kernel, its plain version, SDPA (``enable_gqa`` under GQA) and the
    bound; achieved TFLOP/s and the share of the bound the kernel reaches."""
    hkv = hkv or h
    q = _randn((b, s, h, d), gen, dtype)
    k, v = (_randn((b, s, hkv, d), gen, dtype) for _ in range(2))
    kw = dict(causal=True, scale=1.0 / math.sqrt(d), q_offset=0,
              exp2_impl="exact", num_segments=8, return_lse=lse)
    tile = fwd_tile(dtype, d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel = lambda: flash.flash_attention_fwd(q, k, v, **kw)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hkv != h)  # noqa: E731
    ms, kernel_device_ms = cuda_ms(kernel), profiled_ms(kernel)
    plain_ms = cuda_ms(lambda: flash.flash_attention_fwd_plain(
        q, k, v, block_q=tile, block_k=tile, **kw), iters=plain_iters, warmup=1)
    library_ms = cuda_ms(library)
    library_device_ms, library_kernels = profiled(library)
    flops, nbytes = _attention_cost(b, s, h, d, q.element_size(), hkv)
    nbytes += b * h * s * 4 if lse else 0
    bound_ms, bound_by = _bound(flops, nbytes, peak_flops)
    row = dict(kernel=flash.kernel_for(dtype, d).name, shape=[b, s, h, d], kv_heads=hkv,
               dtype=str(dtype).split(".")[1],
               causal=True, lse=lse, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
               tflops=flops / ms / 1e9, share_of_bound=bound_ms / ms, vs_library=ms / library_ms,
               # The same three on the card alone (the kernel's launches, SDPA's).
               device_ms=kernel_device_ms, library_device_ms=library_device_ms,
               device_tflops=flops / kernel_device_ms / 1e9,
               device_share_of_bound=bound_ms / kernel_device_ms,
               device_vs_library=kernel_device_ms / library_device_ms,
               library_kernels=library_kernels)
    emit("kernels", timing=row)
    return row


def time_flash() -> list[dict]:
    """The sm90 kernel at the serving prefill (B = 1, no LSE) and training
    (B = 4, LSE for the backward) shapes of olmo-1b, at qwen3-moe's
    2048-token prefill (64 q heads over 4 kv heads: GQA rep 16, the same
    work as the training shape) and at zamba2's training shape (32 heads of
    64: the same work again, at d 64); the plain version is slow, so the
    large shapes take 3 timings."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [_time_forward(b, s, h, d, torch.bfloat16, lse, iters, gen, PEAK_BF16_FLOPS, hkv)
            for b, s, h, hkv, d, lse, iters in ((1, 512, 16, 16, 128, False, 20), (1, 2048, 16, 16, 128, False, 20),
                                                (4, 2048, 16, 16, 128, True, 3), (1, 2048, 64, 4, 128, False, 3),
                                                (4, 2048, 32, 32, 64, True, 3))]


# The simt kernel's timed shapes, (B, S, LSE, plain version's timings): the
# fp32 greedy phase's two prefill buckets (37 -> 64; 130 and 256 -> 256),
# the largest fp32 serving bucket, and the fp32 gradient check's forward
# (GRADS_BATCH x GRADS_SEQ, with the LSE the backward reads).
SIMT_TIMED = ((1, 64, False, 20), (1, 256, False, 20), (1, 2048, False, 3), (2, 1024, True, 3))


def time_flash_simt() -> list[dict]:
    """The simt kernel at SIMT_TIMED's causal shapes, 16 heads of 128 (bound
    by the CUDA cores' fp32 rate: fp32 inputs never take the tensor cores;
    SDPA in fp32 as the yardstick)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    return [_time_forward(b, s, 16, 128, torch.float32, lse, iters, gen, PEAK_FP32_FLOPS)
            for b, s, lse, iters in SIMT_TIMED]


def time_simt_q_tiles() -> list[dict]:
    """Device time of the simt kernel at the greedy phase's buckets with
    each q tile, the one simt_q_tile chooses and the other."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for b, s, lse, _ in SIMT_TIMED[:2]:
        q, k, v = (_randn((b, s, 16, 128), gen, torch.float32) for _ in range(3))
        kw = dict(causal=True, scale=128 ** -0.5, q_offset=0, exp2_impl="exact",
                  num_segments=8, return_lse=lse)
        row = dict(shape=[b, s, 16, 128], chosen=flash.simt_q_tile(b, 16, s, flash._sm_count(q.device)))
        for tile in flash.SIMT_Q_TILES:
            row[f"device_ms_q{tile}"] = profiled_ms(lambda: flash._launch(q, k, v, block_q=tile, **kw))
        emit("kernels", simt_q_tiles=row)
        rows.append(row)
    return rows


# -- phase 4: backward kernels -----------------------------------------------------

# Backward kernels vs the plain version on the same inputs, as (atol, rtol).
# fp32: only the order of the fp32 sums differs, over up to Sq * rep terms
# for dK and dV (3200 here), so a little above the forward's 3e-5.  bf16:
# both compute in fp32 (the sm90 pair and its plain twin both round P and
# dS to bf16 as product operands) and round each gradient to bf16 once:
# one bf16 step, as the forward's TOL, with 1e-3 for values near zero.
TOL_BWD = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# The sm90 pair vs the fp32-P plain version (the reference's numerics):
# rounding P and dS to bf16 moves each by at most 2**-8 of itself, so dQ,
# dK and dV move by at most flash_bwd.departure_bound (2**-8 times |dS| |K|,
# |dS|^T |Q| and P^T |dO|, element by element); both sides then round the
# gradient to bf16 (one step, 2**-7 of the value), and 1e-3 covers values
# near zero: |kernel - plain| <= 1e-3 + departure_bound + 2**-7 |plain|.
TOL_BWD_FP32P = (1e-3, 2.0 ** -7)  # (atol, rtol) beside departure_bound
# The sm90 pair vs its twin: both round P and dS to bf16, but from fp32
# values whose sums (S, dP, delta) run in other orders; where the two fp32
# values lie on either side of a bf16 rounding point, the operand rounds to
# neighbouring bf16 values, one ulp (at most 2**-7 of itself) apart.  Each
# gradient then moves by at most 2**-7 times |dS| |K|, |dS|^T |Q| or
# P^T |dO|: twice departure_bound, beside TOL_BWD's one bf16 step.  One
# step alone was exceeded at the training shape (dK used 1.09 of it; a
# first chip run of this check), where 2048 q rows add such flips up.
TOL_BWD_FLIPS = 2.0  # times departure_bound, beside TOL_BWD[torch.bfloat16]

# (B, Sq, Sk, H, Hkv, d, causal, q_offset, dtype, exp2 of the forward)
ZAMBA2_TRAIN_ATTENTION = (4, 2048, 2048, 32, 32, 64, True, 0, torch.bfloat16, "exact")
BWD_SWEEP = [
    (1, 128, 128, 1, 1, 64, False, 0, torch.float32, "exact"),
    (2, 256, 256, 4, 2, 64, True, 0, torch.float32, "exact"),
    (1, 256, 512, 4, 1, 128, True, 256, torch.float32, "exact"),
    (1, 100, 200, 4, 4, 32, True, 100, torch.float32, "pwl"),
    (2, 200, 700, 4, 2, 64, True, 500, torch.float32, "pwl"),
    (2, 64, 64, 8, 2, 16, False, 0, torch.bfloat16, "exact"),
    (1, 77, 130, 8, 4, 32, False, 0, torch.bfloat16, "exact"),
    # The sm90 pair (bf16, d 64 and 128): d 64 with GQA rep 4; Sq and Sk
    # off the 64- and 128-row tiles; q_offset off the tile; the LSE of a PWL
    # forward; B = 3; not causal.
    (1, 256, 256, 8, 2, 64, True, 0, torch.bfloat16, "exact"),
    (2, 100, 200, 4, 2, 64, True, 100, torch.bfloat16, "exact"),
    (1, 17, 300, 8, 2, 64, True, 283, torch.bfloat16, "pwl"),
    (1, 1000, 1000, 8, 2, 64, True, 0, torch.bfloat16, "exact"),
    (1, 300, 812, 16, 16, 128, True, 512, torch.bfloat16, "exact"),
    (1, 512, 512, 16, 16, 128, True, 0, torch.bfloat16, "pwl"),
    (3, 1000, 1000, 16, 16, 128, True, 0, torch.bfloat16, "pwl"),
    (2, 200, 1000, 4, 4, 128, False, 0, torch.bfloat16, "exact"),
    (4, 2048, 2048, 16, 16, 128, True, 0, torch.bfloat16, "exact"),  # training shape
    # The simt pair (fp32; bf16 at d 16 and 32): Sq 1, 17 and 33 around its
    # 16- and 32-row tiles, Sk off them, GQA rep 2 and 4, q_offset > 0, the
    # LSE of a PWL forward, not causal with Sq > Sk; then its timed shapes
    # [1, 256] (16-row tiles on 132 SMs) and [2, 1024] (32-row tiles; the
    # fp32 gradient check's shape).
    (3, 1, 17, 4, 4, 64, True, 16, torch.float32, "exact"),
    (2, 17, 100, 8, 2, 128, True, 83, torch.float32, "pwl"),
    (1, 33, 33, 8, 4, 128, True, 0, torch.float32, "exact"),
    (1, 100, 33, 8, 2, 32, False, 0, torch.bfloat16, "pwl"),
    (2, 17, 50, 4, 1, 16, True, 33, torch.bfloat16, "exact"),
    (1, 256, 256, 16, 16, 128, True, 0, torch.float32, "exact"),
    (2, 1024, 1024, 16, 16, 128, True, 0, torch.float32, "exact"),
    # GQA rep 16 (qwen3-moe): dK/dV sum 16 q heads per kv head; the sm90
    # pair in bf16 and the simt pair in fp32.
    (1, 512, 512, 64, 4, 128, True, 0, torch.bfloat16, "exact"),
    (1, 256, 256, 64, 4, 128, True, 0, torch.float32, "exact"),
    # zamba2's shared attention (32 heads of 64, rep 1): its training shape
    # and a case off the tiles (sm90), the fp32 gradient check's (simt).
    ZAMBA2_TRAIN_ATTENTION,
    (1, 300, 812, 32, 32, 64, True, 512, torch.bfloat16, "exact"),
    (1, 512, 512, 32, 32, 64, True, 0, torch.float32, "exact"),
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


def reset_bwd_counts() -> None:
    for entry in flash_bwd.launch_counts:
        flash_bwd.launch_counts[entry] = 0


def _bwd_twin_err(got, ref, bound):
    """Largest |sm90 kernel - twin|, and the largest share an element uses
    of TOL_BWD alone and of TOL_BWD beside TOL_BWD_FLIPS x departure_bound."""
    atol, rtol = TOL_BWD[torch.bfloat16]
    err = (got.float() - ref.float()).abs()
    step = atol + rtol * ref.float().abs()
    return float(err.max()), float((err / step).max()), float((err / (step + TOL_BWD_FLIPS * bound)).max())


def _bwd_fp32_p_err(got, ref32, bound):
    """Largest |kernel - fp32-P plain| and the largest share of its bound
    (TOL_BWD_FP32P beside departure_bound) an element uses."""
    atol, rtol = TOL_BWD_FP32P
    err = (got.float() - ref32.float()).abs()
    tol = atol + bound + rtol * ref32.float().abs()
    return float(err.max()), float((err / tol).max())


def simt_tiles(q, k) -> tuple[int, int]:
    """The simt pair's resident tiles for these inputs on this card."""
    (b, sq, h, _), (_, sk, hkv, _) = q.shape, k.shape
    return flash_bwd.simt_bwd_tiles(b, h, hkv, sq, sk, flash._sm_count(q.device))


def check_bwd_sweep() -> dict:
    """Largest |kernel - plain| of dQ, and of dK and dV, over the sweep, by
    pair (and, for sm90, against the fp32-P plain version).  The plain
    version runs at the pair's tiles: for simt, dQ at (its q tile, the
    streamed 64) and dK/dV at (64, its k tile)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {(pair, key): 0.0 for pair in ("sm90", "simt") for key in ("dq", "dkv", "dq_fp32_p", "dkv_fp32_p")}
    for case in BWD_SWEEP:
        args, kw = _bwd_inputs(case, gen)
        pair = flash_bwd.bwd_kernel_for(args[0].dtype, args[0].shape[-1])
        tile = bwd_tile(args[0].dtype, args[0].shape[-1])
        before = dict(flash_bwd.launch_counts)
        got = flash_bwd.flash_attention_bwd(*args, **kw)
        fields = {}
        if pair is flash_bwd.SIMT:
            block_q, block_k = simt_tiles(args[0], args[1])
            ref_dq = flash_bwd.flash_attention_bwd_plain(*args, block_q=block_q, block_k=tile, **kw)
            ref_dkv = flash_bwd.flash_attention_bwd_plain(*args, block_q=tile, block_k=block_k, **kw)
            ref = (ref_dq[0], *ref_dkv[1:])
            fields["tiles"] = dict(block_q=block_q, block_k=block_k)
        else:
            ref = flash_bwd.flash_attention_bwd_plain(*args, block_q=tile, block_k=tile, **kw)
        if pair is flash_bwd.SM90:
            ref32 = flash_bwd.flash_attention_bwd_plain(*args, block_q=tile, block_k=tile, fp32_p=True, **kw)
            bounds = flash_bwd.departure_bound(*args, block_q=tile, block_k=tile, **kw)
        torch.cuda.synchronize()
        launched = {e: n - before[e] for e, n in flash_bwd.launch_counts.items()}
        if launched != {e: int(e in pair.entries) for e in launched}:
            raise AssertionError(f"{case} did not launch the {pair.name} pair once: {launched}")
        errs = {}
        for i, (name, g, r) in enumerate(zip(("dq", "dk", "dv"), got, ref)):
            if pair is flash_bwd.SM90:
                err, one_step, used = _bwd_twin_err(g, r, bounds[i])
                errs[name] = dict(max_abs_err=err, tol_used=used, tol_used_one_step=one_step)
            else:
                err, used = _max_err(g, r, case[8], TOL_BWD)
                errs[name] = dict(max_abs_err=err, tol_used=used)
            if not used <= 1.0 or not torch.isfinite(g.float()).all():
                raise AssertionError(f"flash_bwd {name} vs plain mismatch ({err}, tol_used {used}) for {case}")
            key = "dq" if name == "dq" else "dkv"
            worst[pair.name, key] = max(worst[pair.name, key], err)
            if pair is flash_bwd.SM90:
                err32, used32 = _bwd_fp32_p_err(g, ref32[i], bounds[i])
                errs[name].update(max_abs_err_fp32_p=err32, tol_used_fp32_p=used32)
                if not used32 <= 1.0:
                    raise AssertionError(
                        f"sm90 {name} vs fp32-P plain beyond its bound ({err32}, {used32}) for {case}")
                worst[pair.name, key + "_fp32_p"] = max(worst[pair.name, key + "_fp32_p"], err32)
        sm90_tols = {"tol_flips": TOL_BWD_FLIPS, "tol_fp32_p": TOL_BWD_FP32P}
        emit("kernels_bwd", case=str(case[:8] + (str(case[8]), case[9])), kernel=pair.name,
             tol=TOL_BWD[case[8]], **(sm90_tols if pair is flash_bwd.SM90 else {}), **fields, **errs)
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


def _time_bwd_shape(case, peak_flops, plain_iters, gen, full=True) -> dict:
    """One causal backward shape: the whole (dQ with delta, then dK/dV) in
    event and device time, each kernel's device time within it (by the
    profiler's kernel names), SDPA's backward and the bound; achieved
    TFLOP/s and the share of the bound on the device's clock.  With
    ``full`` also the plain version and each kernel launched alone (event
    and device time); without, only the pair's public entry is called (so
    that an older checkout can be timed by this script)."""
    b, s, _, h, hkv, d = case[:6]
    (q, k, v, out, lse, do), kw = _bwd_inputs(case, gen)
    pair = flash_bwd.bwd_kernel_for(q.dtype, d)
    whole = lambda: flash_bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw)  # noqa: E731
    ms, by_kernel = cuda_ms(whole), profiled_by_kernel(whole)

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hkv != h)
    dot = do.transpose(1, 2)
    sdpa = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    library_ms, library_device_ms = cuda_ms(sdpa), profiled_ms(sdpa)

    rows = {}
    # dQ: S, dP, dQ from q, k, v, o, dO, LSE into dQ and delta.  dK/dV: S,
    # dP, dV, dK from q, k, v, dO, LSE, delta.  Whole: five products (S and
    # dP once), q, k, v, o, dO, LSE, delta in and dQ, dK, dV out.
    work = (("dq", (3, 4, 2)), ("dkv", (4, 2, 4)), ("whole", (5, 4, 4)))
    for name, (products, q_sized, kv_sized) in work:
        device_ms = sum(t for n, t in by_kernel.items() if name == "whole" or f"_{name}_kernel" in n)
        flops, nbytes = _bwd_cost(b, s, h, hkv, d, q.element_size(), products, q_sized, kv_sized)
        bound_ms, bound_by = _bound(flops, nbytes, peak_flops)
        rows[name] = dict(device_ms=device_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                          bytes=nbytes, device_tflops=flops / device_ms / 1e9,
                          device_share_of_bound=bound_ms / device_ms)
    rows["whole"].update(ms=ms, vs_library=ms / library_ms,
                         device_vs_library=rows["whole"]["device_ms"] / library_device_ms)
    timing = dict(kernel=pair.name, shape=[b, s, h, d], kv_heads=hkv, dtype=str(q.dtype).split(".")[1], causal=True,
                  library_ms=library_ms, library_device_ms=library_device_ms, **rows)
    if full:
        tile = bwd_tile(q.dtype, d)
        timing["plain_ms"] = cuda_ms(lambda: flash_bwd.flash_attention_bwd_plain(
            q, k, v, out, lse, do, block_q=tile, block_k=tile, **kw), iters=plain_iters, warmup=1)
        # Each kernel alone, on buffers laid out as the wrapper lays them out.
        delta, lse_dkv = flash_bwd._row_stats(pair, lse)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        common = (flash._DTYPE_CODES[q.dtype], b, h, hkv, s, s, d)
        extra = (0, True, kw["scale"] * LOG2_E, kw["scale"], torch.cuda.current_stream().cuda_stream)
        tiles = simt_tiles(q, k) if pair is flash_bwd.SIMT else (None, None)
        alone = dict(
            dq=lambda: flash_bwd._launch_dq(pair, q, k, v, out, do, lse, delta, dq, common, *extra, tiles[0]),
            dkv=lambda: flash_bwd._launch_dkv(pair, q, k, v, do, lse_dkv, delta, dk, dv, common, *extra,
                                              tiles[1]))
        for name, fn in alone.items():
            rows[name].update(ms=cuda_ms(fn), alone_device_ms=profiled_ms(fn))
        if pair is flash_bwd.SIMT:
            timing["tiles"] = dict(block_q=tiles[0], block_k=tiles[1])
    emit("kernels_bwd", timing=timing)
    return timing


# The simt pair's timed shapes (B, S), fp32 causal, 16 heads of 128: a
# short sequence whose 32-row tiles leave SMs idle, the fp32 gradient
# check's shape (GRADS_BATCH x GRADS_SEQ), and a long sequence.
SIMT_BWD_TIMED = ((1, 256), (2, 1024), (1, 2048))


def time_simt_bwd(full: bool = True) -> list[dict]:
    """The simt pair at SIMT_BWD_TIMED (bound by the CUDA cores' fp32 rate;
    SDPA in fp32 as the yardstick); see ``_time_bwd_shape`` for ``full``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    return [_time_bwd_shape((b, s, s, 16, 16, 128, True, 0, torch.float32, "exact"),
                            PEAK_FP32_FLOPS, 3, gen, full) for b, s in SIMT_BWD_TIMED]


def time_simt_bwd_tiles() -> list[dict]:
    """Device time of each simt kernel at the first timed shape with each
    resident tile (the q tile of dQ, the k tile of dK/dV), the chosen one
    and the other."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, s = SIMT_BWD_TIMED[0]
    (q, k, v, out, lse, do), kw = _bwd_inputs((b, s, s, 16, 16, 128, True, 0, torch.float32, "exact"), gen)
    chosen = simt_tiles(q, k)
    rows = []
    for tile in flash_bwd.SIMT_BWD_TILES:
        by_kernel = profiled_by_kernel(lambda: flash_bwd._launch(q, k, v, out, lse, do, tiles=(tile, tile), **kw))
        row = dict(shape=[b, s, 16, 128], tile=tile, chosen=dict(block_q=chosen[0], block_k=chosen[1]),
                   **{f"{name}_device_ms": sum(t for n, t in by_kernel.items() if f"_{name}_kernel" in n)
                      for name in ("dq", "dkv")})
        emit("kernels_bwd", simt_tiles=row)
        rows.append(row)
    return rows


def time_bwd() -> dict:
    """The sm90 pair at olmo's training shape (bf16; the plain version is
    slow, so 3 timings), at rep 16 and at zamba2's training shape (d 64,
    the same work), and the simt pair at its timed shapes and tiles."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    training = next(c for c in BWD_SWEEP if c[0] == 4 and c[1] == 2048 and c[5] == 128)
    # qwen3-moe's rep 16 at the same work: 4 kv heads give dK/dV a quarter
    # of the training shape's CTAs.
    rep16 = (1, 2048, 2048, 64, 4, 128, True, 0, torch.bfloat16, "exact")
    return dict(sm90=_time_bwd_shape(training, PEAK_BF16_FLOPS, 3, gen),
                sm90_rep16=_time_bwd_shape(rep16, PEAK_BF16_FLOPS, 3, gen),
                sm90_d64=_time_bwd_shape(ZAMBA2_TRAIN_ATTENTION, PEAK_BF16_FLOPS, 3, gen),
                simt=time_simt_bwd(), simt_tiles=time_simt_bwd_tiles())


# -- phase 5: the standalone PWL exp2 kernel ----------------------------------------

PWL_SEGMENTS = (2, 4, 8, 16, 32, 64)
PWL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# The tune path's size (every negative normal fp16 value, one Fig. 12
# sweep), and a size that needs the card's whole memory bandwidth.
PWL_SIZES = (30_720, 2 ** 26)
# fp32 operations per element: ceil, x - x_i, (x_f + 1) * K (2), floor, the
# index clip (2), slope * x_f + intercept (2), the exponent update, the flush
# compare.
PWL_OPS = 11


def _pwl_inputs() -> torch.Tensor:
    """tests/test_torch_pwl_exp2.py's inputs, with -inf and NaN added."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        -np.abs(rng.standard_normal(50_000)) * 30.0,
        np.linspace(-152.0, -118.0, 20_001),  # results around the fp32 underflow
        rng.uniform(-1.0, 0.0, 10_000),
        [0.0, -0.0, -1.0, -125.0, -126.0, -127.0, -148.0, -149.0, -1e30, 2.5,
         -np.inf, np.nan],
    ]).astype(np.float32)
    return torch.from_numpy(x).cuda()


def _compare_bits(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """Elements whose bits differ, and the largest |a - b| over them; NaN
    matches NaN whatever its payload."""
    ints = torch.int32 if a.element_size() == 4 else torch.int16
    both_nan = torch.isnan(a.float()) & torch.isnan(b.float())
    differ = (a.view(ints) != b.view(ints)) & ~both_nan
    n = int(differ.sum())
    err = float((a.float() - b.float())[differ].abs().max()) if n else 0.0
    return n, err


def check_pwl() -> tuple[int, float]:
    """The kernel against its plain version on the card, bit for bit; the
    number of elements compared and the largest |kernel - plain|."""
    x32 = _pwl_inputs()
    compared = 0
    max_err = 0.0

    def compare(view: torch.Tensor, k: int, name: str) -> None:
        nonlocal compared, max_err
        out = pwl.pwl_exp2_cuda(view, num_segments=k)
        ref = pwl.pwl_exp2_plain(view, k)
        torch.cuda.synchronize()
        if out.shape != view.shape or out.dtype != view.dtype:
            raise AssertionError(f"pwl_exp2 gave {out.shape} {out.dtype} for {view.shape} {view.dtype}")
        n, err = _compare_bits(out, ref)
        max_err = max(max_err, err)
        if n:
            raise AssertionError(
                f"pwl_exp2 differs from plain on {n} elements, by up to {err} ({view.dtype}, K={k}, {name})")
        compared += view.numel()

    for dtype in PWL_DTYPES:
        x = x32.to(dtype)
        # whole (16-byte vectors and a scalar tail), ragged (misaligned: the
        # scalar path), strided (made contiguous by the wrapper), empty.
        views = {"whole": x, "ragged": x[1:], "strided": x[::3], "empty": x[:0]}
        for k in PWL_SEGMENTS:
            for name, view in views.items():
                compare(view, k, name)
        emit("kernels_pwl", dtype=str(dtype), segments=list(PWL_SEGMENTS),
             views={n: v.numel() for n, v in views.items()}, elements_differing=0)
    # The tune path's own input: the Fig. 12 sweep, fp32.
    fig12 = torch.from_numpy(fp16_negative_normals()).cuda()
    for k in PWL_SEGMENTS:
        compare(fig12, k, "fig12")
    emit("kernels_pwl", dtype="torch.float32", segments=list(PWL_SEGMENTS),
         views={"fig12": fig12.numel()}, elements_differing=0, max_abs_err=max_err)
    return compared, max_err


def time_pwl() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for n in PWL_SIZES:
        x = -30.0 * torch.rand(n, generator=gen, device="cuda")
        ms = cuda_ms(lambda: pwl.pwl_exp2_cuda(x, num_segments=8))
        plain_ms = cuda_ms(lambda: pwl.pwl_exp2_plain(x, 8))
        exp2_ms = cuda_ms(lambda: torch.exp2(x))
        nbytes = 2 * n * x.element_size()  # x read once, the result written once
        bound_ms, bound_by = _bound(PWL_OPS * n, nbytes, PEAK_FP32_FLOPS)
        row = dict(elements=n, dtype="float32", num_segments=8, ms=ms, plain_ms=plain_ms,
                   torch_exp2_ms=exp2_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=PWL_OPS * n, bytes=nbytes)
        emit("kernels_pwl", timing=row)
        rows.append(row)
    return rows


# -- phase 5b: the decode-attention kernel ---------------------------------------------

# (batch, max_len, kv_heads, rep, S, d, dtype): chat's cache (olmo-1b, 128
# slots of 2048), qwen3-moe's rep 16 at a decode step and a verify of 5
# rows, zamba2's d 64, qwen2-vl's rep 7, yi-9b's rep 8, the fp32 smoke
# models' d 16, hubert's d 80 and d 192.
DECODE_SWEEP = (
    (128, 2048, 16, 1, 1, 128, torch.bfloat16), (8, 2048, 4, 16, 1, 128, torch.bfloat16),
    (8, 2048, 4, 16, 5, 128, torch.bfloat16), (16, 1024, 32, 1, 1, 64, torch.bfloat16),
    (4, 500, 4, 7, 1, 128, torch.bfloat16), (4, 300, 4, 8, 2, 128, torch.float32),
    (4, 64, 2, 2, 5, 16, torch.float32), (4, 300, 16, 1, 3, 80, torch.bfloat16),
    (4, 300, 4, 1, 1, 192, torch.float32), (4, 300, 4, 2, 1, 192, torch.bfloat16),
)
# Kernel vs plain version in fp32 before the cast, as a share of the case's
# largest |plain| output: both widen the same values exactly and sum in
# fp32; only the order of the sums differs.
TOL_DECODE = 2e-6
CHAT_CACHE = (128, 2048, 16, 128)  # slots, rows, KV heads, d (bf16)


def _decode_inputs(case, gen, lengths=None):
    """Random q and cache; per-slot lengths (default: random, with 0,
    max_len - 1, max_len and past it)."""
    b, max_len, kv_heads, rep, s_new, d, dtype = case
    q = _randn((b, s_new, kv_heads * rep, d), gen, dtype)
    k, v = (_randn((b, max_len, kv_heads, d), gen, dtype) for _ in range(2))
    if lengths is None:
        lengths = np.random.default_rng(b * max_len + d).integers(0, max_len + 1, b)
        lengths[:4] = (0, max_len - 1, max_len, max_len + 37)[:b]
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device="cuda")


def check_decode_sweep() -> float:
    """Each DECODE_SWEEP case through the kernel (one launch) against the
    plain version; the worst error as a share of its case's largest
    output."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for case in DECODE_SWEEP:
        q, k, v, wp = _decode_inputs(case, gen)
        scale = case[5] ** -0.5
        before = decode_attn.launches
        out = decode_attn.decode_attention_fwd(q, k, v, wp, scale)
        torch.cuda.synchronize()
        if decode_attn.launches != before + 1:
            raise AssertionError(f"{case} did not launch the decode-attention kernel once")
        ref = decode_attn.decode_attention_plain(q, k, v, wp, scale)
        err = float((out - ref).abs().max() / ref.abs().max())
        emit("kernels_decode", case=[*case[:6], str(case[6]).split(".")[1]], err_of_largest=err, tol=TOL_DECODE)
        if not err <= TOL_DECODE:
            raise AssertionError(f"decode attention {case}: {err} of the largest output > {TOL_DECODE}")
        worst = max(worst, err)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return worst


def chat_lengths(seed: int = 5) -> np.ndarray:
    """Chat-like cached lengths of CHAT_CACHE's slots: 92 of 128 live at 200
    to 1299 rows (the cell's slot occupancy, ~72%), the rest retired past
    the cache (they still decode, up to the clamp)."""
    rng = np.random.default_rng(seed)
    slots, rows = CHAT_CACHE[:2]
    lengths = np.concatenate([rng.integers(200, 1300, 92), rows + rng.integers(0, 500, slots - 92)])
    rng.shuffle(lengths)
    return lengths


def time_decode() -> list[dict]:
    """The kernel at chat's cache with every slot full and with chat-like
    lengths: event and device time beside its bound (the rows it reads,
    K and V once, at HBM's rate; operations at the CUDA cores' fp32 rate),
    the plain version and one masked SDPA call over the same cache."""
    slots, rows, kv_heads, d = CHAT_CACHE
    gen = torch.Generator(device="cuda").manual_seed(3)
    timing = []
    for name, lengths in (("full", np.full(slots, rows)), ("chat", chat_lengths())):
        q, k, v, wp = _decode_inputs((slots, rows, kv_heads, 1, 1, d, torch.bfloat16), gen, lengths)
        scale = d ** -0.5
        read = int((np.minimum(lengths, rows - 1) + 1).sum())  # rows each slot sees
        nbytes = 2 * read * kv_heads * d * 2 + q.numel() * 2 + q.numel() * 4
        flops = 4 * read * kv_heads * d
        bound_ms, bound_by = _bound(flops, nbytes, PEAK_FP32_FLOPS)
        kernel = lambda: decode_attn.decode_attention_fwd(q, k, v, wp, scale)  # noqa: E731
        mask = torch.arange(rows, device="cuda")[None, None, None, :] <= wp.long()[:, None, None, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)  # noqa: E731
        ms, (device_ms, kernels) = cuda_ms(kernel), profiled(kernel)
        library_ms, (library_device_ms, library_kernels) = cuda_ms(library, iters=5), profiled(library, iters=5)
        row = dict(lengths=name, shape=[slots, rows, kv_heads, d], dtype="bfloat16", rows_read=read,
                   rows_read_share=read / (slots * rows), ms=ms, device_ms=device_ms, kernels=kernels,
                   plain_ms=cuda_ms(lambda: decode_attn.decode_attention_plain(q, k, v, wp, scale),
                                    iters=3, warmup=1),
                   library_ms=library_ms, library_device_ms=library_device_ms, library_kernels=library_kernels,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                   device_share_of_bound=bound_ms / device_ms, device_tb_per_s=nbytes / device_ms / 1e9,
                   splits=decode_attn.split_plan(slots * kv_heads, rows, torch.cuda.get_device_properties(0)
                                                 .multi_processor_count))
        emit("kernels_decode", timing=row)
        timing.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return timing


# Small batches, every slot full, where the split along the rows has to
# fill the card: chip_smoke's 4-slot olmo-1b serve, qwen3-moe's 8 slots at
# rep 16 (a decode step and a verify of 5 rows); chat's 128 slots beside
# them.
SPLIT_SHAPES = (
    (4, 2048, 16, 1, 1, 128, torch.bfloat16), (8, 2048, 4, 16, 1, 128, torch.bfloat16),
    (8, 2048, 4, 16, 5, 128, torch.bfloat16), (128, 2048, 16, 1, 1, 128, torch.bfloat16),
)


def time_decode_splits() -> list[dict]:
    """Each SPLIT_SHAPES case with ``split_plan``'s split and with one split
    a (slot, KV head): event and device time beside the byte bound."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan, rows = decode_attn.split_plan, []
    for case in SPLIT_SHAPES:
        b, max_len, kv_heads, rep, s_new, d, dtype = case
        q, k, v, wp = _decode_inputs(case, gen, np.full(b, max_len - s_new))
        nbytes = 2 * k.numel() * k.element_size() + q.numel() * (q.element_size() + 4)
        kernel = lambda: decode_attn.decode_attention_fwd(q, k, v, wp, d ** -0.5)  # noqa: E731
        ctas = b * kv_heads * -(-rep * s_new // decode_attn.Q_ROWS_PER_CTA)
        row = dict(case=[*case[:6], str(dtype).split(".")[1]], bound_ms=nbytes / PEAK_BYTES * 1e3,
                   plan=plan(ctas, max_len, sms))
        try:
            for name in ("plan", "one"):
                if name == "one":
                    decode_attn.split_plan = lambda ctas, max_len, sms: (1, max_len)
                row[f"{name}_ms"] = cuda_ms(kernel)
                row[f"{name}_device_ms"] = profiled_ms(kernel)
        finally:
            decode_attn.split_plan = plan
        row["one_over_plan"] = row["one_device_ms"] / row["plan_device_ms"]
        emit("kernels_decode", splits=row)
        rows.append(row)
        del q, k, v
    torch.cuda.empty_cache()
    return rows


# -- phase 6: serve -------------------------------------------------------------

SERVE_PROMPT_LENS = (64, 1536, 200, 700, 96, 1100, 400, 1400)
MAX_NEW = 16


def _attn_layers(cfg) -> int:
    """Flash calls of one forward: one a layer of a transformer, one an
    application of zamba2's shared block, none in xlstm."""
    if cfg.family == "hybrid":
        return -(-cfg.num_layers // max(cfg.attn_every, 1))
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _expected_launches(engine: ServeEngine, prompts, cfg) -> int:
    """Forward launches of the engine's prefills: one a layer a chunk.  The
    recurrent families prefill through decode_step: none."""
    if cfg.family in ("hybrid", "ssm"):
        return 0
    total = 0
    for p in prompts:
        bucket = engine.bucket_for(len(p))
        chunk = min(engine.prefill_chunk or bucket, bucket)
        total += cfg.num_layers * -(-bucket // chunk)
    return total


def _expected_decode_launches(engine: ServeEngine, cfg, prompts) -> int:
    """Decode-attention kernel launches of an engine's run: one an attention
    layer (or application of zamba2's shared block) a decode step, verify or
    draft step; the recurrent families also prefill through decode steps,
    one a token of each prompt's bucket."""
    stats = engine.stats
    steps = stats["decode_steps"] + stats.get("verify_steps", 0) + stats.get("draft_steps", 0)
    if cfg.family in ("hybrid", "ssm"):
        steps += sum(engine.bucket_for(len(p)) for p in prompts)
    return _attn_layers(cfg) * steps


def _path_counts() -> dict:
    """The MoE dispatches by mode, the share of (token, expert) copies
    dropped by capacity and the _int_mm calls since the last reset."""
    copies = moe.counts["copies_capacity"] + moe.counts["copies_dropless"]
    return dict(moe_calls={m: moe.counts[m] for m in ("capacity", "dropless")},
                moe_dropped_share=moe.dropped_copies() / copies if copies else 0.0,
                int_mm_calls=quantize.int_mm_calls)


def reset_path_counts() -> None:
    reset_fwd_counts()
    decode_attn.launches = 0
    moe.reset_counts()
    quantize.reset_counts()


def _prefill_vs_naive(cfg, params, prompt, phase) -> dict:
    """One request's prefill logits (bucket 1024): kernel path vs
    naive-attention path, relative to the largest naive logit.

    For a MoE model the two paths' bf16 attention outputs differ by
    rounding, which flips some tokens' top-k experts, and a flip moves the
    capacity positions of every later copy of those experts: its logits
    cannot be held to TOL_PREFILL_REL (0.161 on qwen3-moe at depth 4, argmax
    agreement 0.92, in the first card run).  There the gate is the first
    layer's attention output on the model's own input, kernel against
    naive, with the tokens whose first-layer experts differ counted; the
    whole model's numbers are reported beside it."""
    bucket = 1024
    toks = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device="cuda")
    naive_cfg = dataclasses.replace(cfg, attention_impl="naive")
    with torch.no_grad():
        got, _ = prefill_step(params, cfg, toks, init_cache(cfg, 1, bucket, "cuda"), [len(prompt)])
        ref, _ = prefill_step(params, naive_cfg, toks, init_cache(cfg, 1, bucket, "cuda"), [len(prompt)])
    got, ref = got[0, :len(prompt)].float(), ref[0, :len(prompt)].float()
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    row = dict(arch=cfg.name, quant=_quant_flag(cfg), prompt_len=len(prompt), max_rel_err=rel,
               tol=TOL_PREFILL_REL, argmax_agreement=agree)
    gated = rel
    if cfg.moe is not None:
        row.update(_first_layer_vs_naive(cfg, params, toks[:, :len(prompt)]))
        gated = row["layer0_attention_max_rel_err"]
    emit(phase, prefill_logits_vs_naive=row)
    if not (gated <= TOL_PREFILL_REL and torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name} prefill differs from the naive path: {row}")
    return row


def _first_layer_vs_naive(cfg, params, toks) -> dict:
    """The first layer's attention output, kernel path vs naive path, on the
    prompt's embeddings (relative to the largest naive value), and the
    tokens whose top-k experts of that layer differ between the paths."""
    layer = _layer(params["layers"], 0)
    x = params["embed"][toks]
    pos = torch.arange(toks.shape[1], device="cuda", dtype=torch.int32)[None]
    with torch.no_grad():
        h = apply_norm(x, layer["attn_norm"], cfg.norm_type)
        outs = [attention_forward(h, layer["attn"], c, pos)
                for c in (cfg, dataclasses.replace(cfg, attention_impl="naive"))]
        experts = []
        for a in outs:
            hn = apply_norm(x + a, layer["mlp_norm"], cfg.norm_type)
            logits = hn.reshape(-1, cfg.d_model).float() @ layer["moe"]["router"]
            experts.append(torch.topk(logits, cfg.moe.top_k, dim=-1).indices.sort(dim=-1).values)
    got, ref = (a.float() for a in outs)
    flips = int((experts[0] != experts[1]).any(dim=-1).sum())
    return dict(layer0_attention_max_rel_err=float((got - ref).abs().max() / ref.abs().max()),
                layer0_routing_flips=flips, tokens=toks.shape[1])


def _layer(stacked, i):
    """Layer ``i`` of a stacked params dict (``None`` leaves stay)."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return None if stacked is None else stacked[i]


# A second wave in the buckets SERVE_PROMPT_LENS touched (64, 128, 256, 512,
# 1024, 2048), other lengths: an engine's compile counts must not move.
SECOND_WAVE_LENS = (50, 1600, 180, 600, 100, 1000, 300, 1300)
SECOND_WAVE_NEW = 4


def second_wave(engine: ServeEngine, cfg, phase: str, name: str) -> dict:
    """Serve SECOND_WAVE_LENS's requests on ``engine`` after its first run;
    its ``compile_counts()`` (the argument signatures per phase) must stay as
    they were."""
    counts = engine.compile_counts()
    rng = np.random.default_rng(1)
    for i, n in enumerate(SECOND_WAVE_LENS):
        engine.submit(Request(rid=100 + i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                              max_new_tokens=SECOND_WAVE_NEW))
    done = engine.run()
    after = engine.compile_counts()
    emit(phase, **{f"{name}_compile_counts": dict(first_wave=counts, second_wave=after)})
    if after != counts or len(done) != len(SECOND_WAVE_LENS):
        raise AssertionError(f"{name}: a second wave in the same buckets moved the compile counts "
                             f"{counts} -> {after} ({len(done)} requests done)")
    return counts


def serve(cfg, params, phase: str = "serve", *, mesh=None, chunks=(None, 512), vs_naive: bool = True,
          waves: bool = False) -> dict:
    """The engine on SERVE_PROMPT_LENS's requests, unchunked and chunked
    (``chunks``), with ``mesh`` under a device mesh (params placed by the
    caller); with ``waves``, a second wave on the unchunked engine
    (``second_wave``)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    # Warm-up (not counted, not timed): CUDA context, cuBLAS handles, the
    # kernel's library load.
    warm = ServeEngine(cfg, params, batch_size=4, max_len=2048, device="cuda", mesh=mesh)
    warm.submit(Request(rid=-1, prompt=prompts[0], max_new_tokens=2))
    warm.run()
    del warm  # its cache must not count in the runs' peak memory

    runs, launches, decode_total, outputs = [], 0, 0, {}
    for chunk in chunks:
        engine = ServeEngine(cfg, params, batch_size=4, max_len=2048,
                             prefill_chunk=chunk, device="cuda", mesh=mesh)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_path_counts()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_kernel = dict(flash.launch_counts)
        run_launches = sum(by_kernel.values())
        expected = _expected_launches(engine, prompts, cfg)
        if by_kernel != dict(sm90=expected, simt=0):
            raise AssertionError(
                f"forward launched {run_launches} times ({by_kernel}), expected {expected} "
                f"all sm90 (prefill_chunk={chunk})"
            )
        if len(done) != len(prompts) or any(len(r.output) != MAX_NEW for r in done):
            raise AssertionError(f"engine finished {len(done)} requests, not all with {MAX_NEW} tokens")
        decode_launches = decode_attn.launches
        if decode_launches != _expected_decode_launches(engine, cfg, prompts):
            raise AssertionError(f"decode attention launched {decode_launches} times in "
                                 f"{engine.stats['decode_steps']} decode steps of {_attn_layers(cfg)} layers")
        launches += run_launches
        decode_total += decode_launches
        outputs[chunk] = {r.rid: r.output for r in done}
        ttft, tpot = request_latencies(done)
        toks = sum(len(r.output) for r in done)
        run = dict(arch=cfg.name, layers=cfg.num_layers, quant=_quant_flag(cfg), prefill_chunk=chunk,
                   mesh=None if mesh is None else "x".join(map(str, mesh.shape)),
                   requests=len(done), tokens=toks, seconds=dt,
                   tokens_per_s=toks / dt, ttft_ms_p50=float(np.median(ttft)) * 1e3,
                   prefill_ms_p50=float(np.median(
                       [r.t_first_token - r.t_prefill for r in done])) * 1e3,
                   tpot_ms_p50=float(np.median(tpot)) * 1e3,
                   flash_launches=run_launches, flash_launches_by_kernel=by_kernel,
                   decode_attention_launches=decode_launches,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                   **(_path_counts() if cfg.moe is not None or cfg.quant is not None else {}),
                   stats=engine.stats, compile_counts=engine.compile_counts())
        if cfg.moe is not None and (run["moe_calls"]["capacity"] == 0 or run["moe_calls"]["dropless"] == 0):
            raise AssertionError(f"MoE layers ran {run['moe_calls']}: expected capacity prefills and dropless decode")
        if cfg.quant is not None and run["int_mm_calls"] == 0:
            raise AssertionError(f"the {run['quant']} policy made no _int_mm call")
        emit(phase, **run)
        runs.append(run)
        if waves and chunk is None:
            second_wave(engine, cfg, phase, f"{cfg.name}_serve")
        del engine  # its cache must not count in the next run's peak
    if len(chunks) > 1:
        same = sum(outputs[None][i] == outputs[512][i] for i in outputs[None])
        emit(phase, chunked_equals_unchunked=f"{same}/{len(prompts)} requests")
    return dict(runs=runs, launches=launches, decode_launches=decode_total, outputs=outputs,
                prefill_vs_naive=_prefill_vs_naive(cfg, params, prompts[3], phase) if vs_naive else None)


def _quant_flag(cfg) -> str:
    return "none" if cfg.quant is None else next(
        f for f in QUANT_FLAGS if parse_quant(f) == cfg.quant)


# -- phase 7: greedy equivalence in fp32 ------------------------------------------

GREEDY_PROMPT_LENS = (37, 130, 256)


def _reference_top2_gap(cfg, params, tokens) -> float:
    """Top-1 minus top-2 logit of sequential decode after ``tokens``."""
    cache = init_cache(cfg, 1, len(tokens), "cuda")
    for i, t in enumerate(tokens):
        logits, cache = decode_step(params, cfg, torch.tensor([[int(t)]], device="cuda"), cache, i)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _near_tie(cfg, params, context) -> dict:
    """The reference path's top-2 logit gap after ``context`` (sequential
    decode) and, for a MoE model, its smallest router margin on the way; a
    difference of two paths there is allowed when either is a near-tie."""
    moe.reset_counts()
    moe.track_margins = cfg.moe is not None
    gap = _reference_top2_gap(cfg, params, context)
    moe.track_margins = False
    margin = moe.min_router_margin()
    row = dict(reference_top2_gap=gap, **({"reference_min_router_margin": margin} if cfg.moe is not None else {}))
    return dict(row, near_tie=gap <= NEAR_TIE or margin <= ROUTER_NEAR_TIE)


def greedy(cfg, phase: str = "greedy", prompt_lens=GREEDY_PROMPT_LENS, max_new=MAX_NEW,
           max_len=512) -> dict:
    params = init_params(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in prompt_lens]
    engine = ServeEngine(cfg, params, batch_size=2, max_len=max_len, device="cuda")
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    torch.cuda.synchronize()
    reset_path_counts()
    done = {r.rid: r.output for r in engine.run()}
    torch.cuda.synchronize()
    by_kernel = dict(flash.launch_counts)
    engine_counts, decode_launches = _path_counts(), decode_attn.launches
    expected = _expected_launches(engine, prompts, cfg)
    if by_kernel != dict(sm90=0, simt=expected):
        raise AssertionError(f"fp32 prefills launched {by_kernel}, expected {expected} all simt")
    if decode_launches != _expected_decode_launches(engine, cfg, prompts):
        raise AssertionError(f"fp32 decode attention launched {decode_launches} times in "
                             f"{engine.stats['decode_steps']} decode steps")
    near_ties = 0
    with torch.no_grad():
        for i, p in enumerate(prompts):
            ref = sequential_greedy_decode(cfg, params, p, max_new, max_len=max_len)
            if done[i] == ref:
                continue
            t = next(j for j, (a, b) in enumerate(zip(done[i], ref)) if a != b)
            tie = _near_tie(cfg, params, np.concatenate([p, ref[:t]]))
            emit(phase, rid=i, first_difference=t, **{k: v for k, v in tie.items() if k != "near_tie"})
            if not tie["near_tie"]:
                raise AssertionError(f"request {i}: engine {done[i]} != sequential {ref}")
            near_ties += 1
    emit(phase, arch=cfg.name, layers=cfg.num_layers, requests=len(prompts), tokens_each=max_new,
         near_ties=near_ties, identical=len(prompts) - near_ties, flash_launches_by_kernel=by_kernel,
         decode_attention_launches=decode_launches, **(engine_counts if cfg.moe is not None else {}))
    return dict(near_ties=near_ties, launches=by_kernel["simt"], decode_launches=decode_launches)


# -- phase 8: train --------------------------------------------------------------

TRAIN_SHAPE = ShapeConfig("chip_smoke", 2048, 4, "train")  # seq 2048, batch 4
TRAIN_STEPS = 6
# The reference's peak lr, 3e-4, reached after 2 warm-up steps (not its
# default 10): the params are bf16 with no fp32 master copy, so an update
# much below half a bf16 step of a weight (~6e-5 at the init's ~0.02)
# rounds away.  A peak of 1e-3 made the loss climb from 10.1 to 16.2 at
# full width before it fell again.
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2


def train(cfg, shape=TRAIN_SHAPE, phase: str = "train", *, steps: int = TRAIN_STEPS, mesh=None) -> dict:
    """The port's Trainer on a full-width model (olmo-1b in the train
    phase), ``steps`` steps, under ``mesh`` if given; launch counts of the
    run (forward, with the remat recompute, and each backward kernel, per
    flash call of the model), and its JSONL metrics stream read back through
    scrape_log.  The losses of the first steps do not depend on ``steps``
    (the lr schedule's warm-up ends at step TRAIN_WARMUP).  A run of
    TRAIN_STEPS must end below its first loss; a shorter one (the dist
    phase's, gated by equality with the train phase's losses) need not: the
    third loss rose above the first in a run of six (11.12, 9.57, 15.61)."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        jsonl = Path(ckpt_dir) / "metrics.jsonl"
        tcfg = TrainerConfig(total_steps=steps, ckpt_every=steps + 1, ckpt_dir=ckpt_dir,
                             peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, log_every=1, seed=0,
                             metrics_jsonl=str(jsonl))
        trainer = Trainer(cfg, shape, tcfg, device="cuda", mesh=mesh)
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_fwd_counts()
        reset_bwd_counts()
        state = trainer.run(state)
        torch.cuda.synchronize()
        launches = dict(flash_fwd=flash.launch_counts["sm90"], flash_fwd_simt=flash.launch_counts["simt"],
                        **flash_bwd.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        records = scrape_log.scrape(jsonl.read_text())
    losses = state["losses"]
    steps_s = list(trainer.watchdog.durations)
    tokens = shape.global_batch * shape.seq_len
    step_s = float(np.median(steps_s[1:]))  # the first step also warms up
    calls = _attn_layers(cfg) * steps
    expected = dict(flash_fwd=calls * (2 if cfg.remat else 1), flash_fwd_simt=0,
                    flash_bwd_sm90_dq=calls, flash_bwd_sm90_dkv=calls, flash_bwd_dq=0, flash_bwd_dkv=0)
    emit(phase, arch=cfg.name, dtype=cfg.dtype, remat=cfg.remat, batch=shape.global_batch,
         mesh=None if mesh is None else "x".join(map(str, mesh.shape)),
         seq=shape.seq_len, losses=losses, step_seconds=steps_s, step_s_median=step_s,
         tokens_per_s=tokens / step_s, max_memory_allocated_gb=peak_gb,
         launches=launches, expected_launches=expected)
    mfu = trainer.registry.get("mfu").labels(phase="train").value
    emit(phase, metrics_jsonl_records=len(records), metrics_jsonl_losses=[r["loss"] for r in records],
         mfu_vs_paper_fsa_array=mfu, mfu_denominator=MFU_DENOMINATOR)
    if len(records) != steps or not all(math.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"scrape_log read {len(records)} records of the metrics stream: {records}")
    if launches != expected:
        raise AssertionError(f"training launched {launches}, expected {expected}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite at every step: {losses}")
    if steps >= TRAIN_STEPS and not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return dict(launches=launches, step_s=step_s, step_seconds=steps_s, tokens_per_s=tokens / step_s,
                losses=losses, max_memory_allocated_gb=peak_gb)


# -- phase 9: gradients, kernel path vs naive path ---------------------------------

GRADS_DEPTH, GRADS_BATCH, GRADS_SEQ = 2, 2, 1024
# Each leaf's max |kernel - naive| over its max |naive|.  fp32: the two paths
# round attention differently (~1e-6 of the largest gradient when this
# comparison runs on the CPU at depth 1); 1e-4 leaves two orders for the
# sums of a card.  bf16: activations and gradients round to bf16 at every
# layer, and the naive path's gradients of q, k, v are rounded from other
# fp32 values than the kernel's (~8e-3 on the CPU at depth 1); 5e-2 is ~6
# bf16 steps (2**-7) of the largest gradient.
TOL_GRADS = {"float32": 1e-4, "bfloat16": 5e-2}


def grads(cfg, tols=TOL_GRADS, depth=GRADS_DEPTH, batch=GRADS_BATCH, seq=GRADS_SEQ,
          phase: str = "grads") -> dict:
    """Largest relative gradient error by dtype, and the forward and
    backward launches of each kernel path (fp32: the simt forward and pair;
    bf16: the sm90 forward and pair; the forward once per flash call of the
    model (a layer; an application of zamba2's shared block), twice with
    remat, and one launch of each backward kernel per call)."""
    worst, launches, fwd_launches = {}, {}, {}
    for dtype, tol in tols.items():
        small = dataclasses.replace(cfg, num_layers=depth, dtype=dtype)
        params = init_params(small, seed=2, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        toks = torch.randint(0, small.vocab_size, (batch, seq + 1), generator=gen, device="cuda")
        batch_ = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_path_counts()
        reset_bwd_counts()
        loss, got = value_and_grad(small, params, batch_)
        torch.cuda.synchronize()
        launches[dtype] = dict(flash_bwd.launch_counts)
        fwd_launches[dtype] = dict(flash.launch_counts)
        pair = flash_bwd.bwd_kernel_for(small.activation_dtype, small.resolved_head_dim)
        calls = _attn_layers(small)
        expected = {e: calls * (e in pair.entries) for e in flash_bwd.launch_counts}
        if launches[dtype] != expected:
            raise AssertionError(f"{dtype} gradients launched {launches[dtype]}, expected {expected}")
        fwd = flash.kernel_for(small.activation_dtype, small.resolved_head_dim).name
        fwd_expected = {name: calls * (2 if small.remat else 1) * (name == fwd) for name in flash.launch_counts}
        if fwd_launches[dtype] != fwd_expected:
            raise AssertionError(f"{dtype} forward launched {fwd_launches[dtype]}, expected {fwd_expected}")
        extra = _path_counts() if small.moe is not None else {}
        ref_loss, ref = value_and_grad(dataclasses.replace(small, attention_impl="naive"), params, batch_)
        rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                  for a, b in zip(tree_leaves(got), tree_leaves(ref)))
        emit(phase, arch=small.name, dtype=dtype, depth=depth, batch=batch, seq=seq,
             loss=float(loss), naive_loss=float(ref_loss), max_rel_err=rel, tol=tol,
             fwd_launches=fwd_launches[dtype], bwd_launches=launches[dtype],
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
        if not rel <= tol or not math.isfinite(float(loss)):
            raise AssertionError(f"{dtype} gradients differ from the naive path: {rel} > {tol}")
        worst[dtype] = rel
        del params, got, ref
        torch.cuda.empty_cache()
    return dict(worst=worst, launches=launches, fwd_launches=fwd_launches)


# -- phase 11: MoE and int8 ----------------------------------------------------------

# qwen3-moe-235b-a22b at full width (d_model 4096, 64 heads of 128 over 4 kv
# heads: GQA rep 16; 128 experts of 1536, top 8; vocab 151936), its depth
# cut from 94 to fit the card: 4 layers in bf16 to serve (about 22.4 GB of
# weights), 2 in fp32 for the greedy check (about 24.9 GB), 1 in fp32 for
# the gradient check (about 30 GB with the gradients).  arctic-480b at full
# width, depth 1 of 35, bf16 (one layer's experts are 26.8 GB).
MOE_ARCH, ARCTIC_ARCH = "qwen3-moe-235b-a22b", "arctic-480b"
MOE_SERVE_DEPTH, MOE_GREEDY_DEPTH, ARCTIC_DEPTH = 4, 2, 1
MOE_GRADS = dict(depth=1, batch=1, seq=512)
ARCTIC_DECODE_STEPS = 4
# int8 products held against the CPU's exact version: experts of the
# batched prefill product compared (the CPU's int32 product is slow; each
# expert's result depends on its own rows and weights only).
INT8_EXPERTS_CHECKED = 8


def check_int8_products(cfg) -> list[dict]:
    """int8_dot and int8_dot_batched on the card at the MoE serve path's
    shapes against the CPU version on the same inputs: the int32
    accumulators and the outputs bit for bit, per channel and per tensor."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    d, f, e, hd = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts, cfg.resolved_head_dim
    prefill_t = 2048
    capacity = int(prefill_t * cfg.moe.top_k * cfg.moe.capacity_factor / e)
    # (name, x shape, w shape, experts compared): a 2048-token prefill's k
    # projection, a B = 4 decode step's q projection (padded to 17 rows),
    # the expert products of that prefill (capacity rows an expert) and of
    # the decode step (dropless: 4 rows an expert, padded).
    cases = [("int8_dot", (prefill_t, d), (d, cfg.num_kv_heads * hd), None),
             ("int8_dot", (4, d), (d, cfg.num_heads * hd), None),
             ("int8_dot_batched", (e, capacity, d), (e, d, f), INT8_EXPERTS_CHECKED),
             ("int8_dot_batched", (e, 4, d), (e, d, f), e)]
    rows = []
    for name, xs, ws, n in cases:
        x = _randn(xs, gen, torch.bfloat16)
        w = (_randn(ws, gen, torch.float32) / math.sqrt(ws[-2])).to(torch.bfloat16)
        experts = name == "int8_dot_batched"
        fn = int8_dot_batched if experts else int8_dot
        for per_channel in (True, False):
            before = quantize.int_mm_calls
            acc, _, _ = quantize.int8_accumulate(x, w, per_channel, experts)
            out = fn(x, w, per_channel=per_channel)
            torch.cuda.synchronize()
            calls = quantize.int_mm_calls - before
            xc, wc = (x[:n], w[:n]) if experts else (x, w)
            acc_cpu, _, _ = quantize.int8_accumulate(xc.cpu(), wc.cpu(), per_channel, experts)
            out_cpu = fn(xc.cpu(), wc.cpu(), per_channel=per_channel)
            acc_equal = torch.equal(acc[:n].cpu() if experts else acc.cpu(), acc_cpu)
            out_equal = torch.equal(out[:n].cpu() if experts else out.cpu(), out_cpu)
            row = dict(product=name, x=list(xs), w=list(ws), per_channel=per_channel,
                       experts_compared=n, int_mm_calls=calls, acc_bit_equal=acc_equal,
                       out_bit_equal=out_equal, acc_max_abs=int(acc.abs().max()))
            emit("moe", int8_check=row)
            rows.append(row)
            if not (acc_equal and out_equal):
                raise AssertionError(f"int8 product on the card differs from the CPU's: {row}")
            if calls != 2 * (xs[0] if experts else 1):  # acc and out: one call an expert each
                raise AssertionError(f"{name} made {calls} _int_mm calls: {row}")
    return rows


def moe_bit_equal(cfg, params) -> dict:
    """Two moe_forward calls on one bf16 input give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = _randn((1, 2048, cfg.d_model), gen, torch.bfloat16)
    with torch.no_grad():
        first, second = moe.moe_forward(x, layer, cfg), moe.moe_forward(x, layer, cfg)
    row = dict(shape=list(x.shape), bit_equal=bool(torch.equal(first, second)),
               finite=bool(torch.isfinite(first).all()))
    emit("moe", moe_forward_twice=row)
    if not (row["bit_equal"] and row["finite"]):
        raise AssertionError(f"moe_forward is not repeatable: {row}")
    return row


def arctic(cfg) -> dict:
    """arctic-480b at full width: one prefill's logits against the naive
    path (the dense residual beside the experts), then decode steps."""
    params = init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 700).astype(np.int32)
    torch.cuda.synchronize()
    reset_path_counts()
    naive = _prefill_vs_naive(cfg, params, prompt, "moe")
    launches = dict(flash.launch_counts)
    # The kernel path's prefill, one launch a layer, and the first layer's
    # attention alone.
    if launches != dict(sm90=cfg.num_layers + 1, simt=0):
        raise AssertionError(f"arctic prefill launched {launches}, expected {cfg.num_layers + 1} sm90")
    cache = init_cache(cfg, 1, 1024, "cuda")
    toks = torch.as_tensor(prompt[None], device="cuda")
    with torch.no_grad():
        logits, cache = prefill_step(params, cfg, toks, cache, [len(prompt)])
        finite = [bool(torch.isfinite(logits).all())]
        tok = logits[:, -1:].argmax(-1)
        for i in range(ARCTIC_DECODE_STEPS):
            logits, cache = decode_step(params, cfg, tok, cache, len(prompt) + i)
            finite.append(bool(torch.isfinite(logits).all()))
            tok = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    row = dict(arch=cfg.name, layers=cfg.num_layers, decode_steps=ARCTIC_DECODE_STEPS, finite=finite,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, **_path_counts())
    emit("moe", arctic=row)
    if not all(finite):
        raise AssertionError(f"arctic logits not finite: {row}")
    del params, cache
    return dict(prefill_vs_naive=naive, launches=launches["sm90"], **row)


def moe_phase() -> dict:
    """The MoE and int8 slice on the card (see the module docstring)."""
    full = get_config(MOE_ARCH)
    int8_rows = check_int8_products(full)
    cfg = dataclasses.replace(full, num_layers=MOE_SERVE_DEPTH)
    params = init_params(cfg, seed=0, device="cuda")
    bit_equal = moe_bit_equal(cfg, params)
    served = {}
    for flag in ("none", "int8"):  # both policies serve the same weights
        qcfg = dataclasses.replace(get_config(MOE_ARCH, flag), num_layers=MOE_SERVE_DEPTH)
        served[flag] = serve(qcfg, params, "moe")
    del params
    torch.cuda.empty_cache()
    # fp32 greedy at capacity_factor E / k: prefill drops nothing, so the
    # engine must give sequential (dropless) decode's tokens.
    greedy_cfg = dataclasses.replace(
        full, num_layers=MOE_GREEDY_DEPTH, dtype="float32",
        moe=dataclasses.replace(full.moe, capacity_factor=full.moe.num_experts / full.moe.top_k))
    greedied = greedy(greedy_cfg, "moe")
    torch.cuda.empty_cache()
    graded = grads(full, {"float32": TOL_GRADS["float32"]}, phase="moe", **MOE_GRADS)
    torch.cuda.empty_cache()
    arctic_cfg = dataclasses.replace(get_config(ARCTIC_ARCH), num_layers=ARCTIC_DEPTH)
    arcticked = arctic(arctic_cfg)
    torch.cuda.empty_cache()
    return dict(int8=int8_rows, bit_equal=bit_equal, served=served, greedy=greedied, grads=graded,
                arctic=arcticked)


# -- phase 12: speculative decoding and telemetry ----------------------------------------

SPEC_K = 4
# The greedy phase's prompts (the same rng), and one of CAPACITY_PROMPT
# tokens: in a 512-slot cache its first verify round writes rows 508 to 512
# and drops the last, whatever the draft's acceptance.
CAPACITY_PROMPT = 508
SPEC_GREEDY_PROMPT_LENS = GREEDY_PROMPT_LENS + (CAPACITY_PROMPT,)


def _spec_run(cfg, params, prompts, spec, *, batch_size, max_len, chunk=None, tracer=None, record=False,
              mesh=None):
    """Serve ``prompts`` speculatively with counts reset before and read
    after, under ``mesh`` if given (params placed by the caller); with
    ``record``, every verify round's positions, live slots and ``accepted``
    (on the device, read after the run) are kept to find the first rejected
    draft."""
    engine = ServeEngine(cfg, params, batch_size=batch_size, max_len=max_len, prefill_chunk=chunk,
                         spec=spec, tracer=tracer, device="cuda", mesh=mesh)
    rounds = []
    if record:
        verify = engine._verify

        def recording(params_, cache, tokens, positions):
            greedy_, accepted, cache = verify(params_, cache, tokens, positions)
            live = {i: (r.rid, len(r.output)) for i, r in enumerate(engine.slots) if r is not None}
            rounds.append((engine._positions.copy(), live, accepted))
            return greedy_, accepted, cache

        engine._verify = recording
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(flash=dict(flash.launch_counts), decode_attention_launches=decode_attn.launches, **_path_counts())
    return engine, {r.rid: r for r in done}, dt, counts, rounds


def _first_rejection(rounds, k, max_len):
    """(rid, output index) of the first live draft the target rejected
    where the cache's capacity did not cap it, and the rows dropped past
    capacity over the run."""
    first, dropped = None, 0
    for positions, live, accepted in rounds:
        accepted = accepted.cpu().numpy()
        for slot, (rid, emitted) in live.items():
            cap = max_len - int(positions[slot]) - 1
            dropped += max(int(positions[slot]) + k + 1 - max_len, 0)
            if first is None and accepted[slot] < min(k, cap):
                first = (rid, emitted + int(accepted[slot]))
    return first, dropped


def spec_serve(cfg, params, vanilla: dict) -> dict:
    """The serve phase's engine and requests, speculative: self-draft and
    the int8 draft, unchunked and chunked.  Every prefill (target and draft)
    goes through the sm90 forward.  The self-draft unchunked run is traced
    and its telemetry checked."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    runs, launches, decode_launches, telemetry, outputs = [], 0, 0, None, {}
    for draft_quant in (None, "int8"):
        spec = SpecConfig(lookahead=SPEC_K, draft_quant=draft_quant)
        # Warm-up (not counted, not timed): the draft policy's first calls.
        _spec_run(cfg, params, prompts[:1], spec, batch_size=4, max_len=2048)
        for chunk in (None, 512):
            tracer = Tracer(process_name="chip_smoke spec") if draft_quant is None and chunk is None else None
            engine, done, dt, counts, _ = _spec_run(cfg, params, prompts, spec, batch_size=4, max_len=2048,
                                                    chunk=chunk, tracer=tracer)
            expected = 2 * _expected_launches(engine, prompts, cfg)  # target and draft prefills
            if counts["flash"] != dict(sm90=expected, simt=0):
                raise AssertionError(f"spec forward launched {counts['flash']}, expected {expected} all sm90 "
                                     f"(draft_quant={draft_quant}, prefill_chunk={chunk})")
            if len(done) != len(prompts) or any(len(r.output) != MAX_NEW for r in done.values()):
                raise AssertionError(f"spec engine finished {len(done)} requests, not all with {MAX_NEW} tokens")
            if counts["decode_attention_launches"] != _expected_decode_launches(engine, cfg, prompts):
                raise AssertionError(f"spec decode attention launched {counts['decode_attention_launches']} times "
                                     f"in {engine.stats['verify_steps']} verify and {engine.stats['draft_steps']} "
                                     f"draft steps of {_attn_layers(cfg)} layers")
            launches += expected
            decode_launches += counts["decode_attention_launches"]
            same = sum(done[i].output == vanilla[chunk][i] for i in done)
            run = _spec_row(cfg, engine, done, dt, counts, "self" if draft_quant is None else "self@int8", chunk,
                            equal_to_vanilla=f"{same}/{len(done)} requests")
            emit("spec", **run)
            runs.append(run)
            outputs[draft_quant, chunk] = {i: r.output for i, r in done.items()}
            if tracer is not None:
                telemetry = check_telemetry(engine, tracer)
                second_wave(engine, cfg, "spec", f"{cfg.name}_spec_self")
            del engine, done  # its caches must not count in the next run's peak
    return dict(runs=runs, launches=launches, decode_launches=decode_launches, telemetry=telemetry,
                outputs=outputs)


def _spec_row(cfg, engine, done, dt, counts, draft, chunk, **more) -> dict:
    """A speculative run's serving metrics, steps and counts."""
    ttft, tpot = request_latencies(done.values())
    toks = sum(len(r.output) for r in done.values())
    stats = engine.stats
    return dict(arch=cfg.name, layers=cfg.num_layers, quant=_quant_flag(cfg), draft=draft, lookahead=SPEC_K,
                prefill_chunk=chunk, requests=len(done), tokens=toks, seconds=dt, tokens_per_s=toks / dt,
                ttft_ms_p50=float(np.median(ttft)) * 1e3, tpot_ms_p50=float(np.median(tpot)) * 1e3,
                tpot_amortized_ms_p50=engine.registry.get("serve_tpot_seconds").percentile(50) * 1e3,
                verify_steps=stats["verify_steps"], draft_steps=stats["draft_steps"],
                acceptance=engine.acceptance_rate(), **more,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                flash_launches_by_kernel=counts["flash"], stats=stats, compile_counts=engine.compile_counts())


def check_telemetry(engine, tracer) -> dict:
    """The traced run's Chrome trace: valid JSON, one verify span a verify
    step, k + 1 draft steps a draft span, the request spans; the registry's
    serve_*_total counters equal engine.stats; its MFU gauges."""
    stats, k = engine.stats, engine.spec.lookahead
    with tempfile.TemporaryDirectory() as d:
        doc = json.loads(Path(tracer.save(str(Path(d) / "spec_trace.json"))).read_text())
    events = doc["traceEvents"]
    names = [e["name"] for e in events]
    drafts = [e for e in events if e["name"] == "draft"]
    # Where a round's time goes, from the spans: the K+1 draft steps, the
    # verify, and a prefill (target; the draft's mirror is outside it).
    span_ms = {name: float(np.mean([e["dur"] for e in events if e["name"] == name])) / 1e3
               for name in ("draft", "verify", "prefill")}
    counters = {key: int(engine.registry.get(f"serve_{key}_total").value) for key in stats}
    mfu = {phase: engine.registry.get("mfu").labels(phase=phase).value for phase in ("prefill", "verify")}
    row = dict(trace_events=len(events), verify_spans=names.count("verify"), draft_spans=len(drafts),
               prefill_spans=names.count("prefill"), request_spans=names.count("queued"),
               span_ms_mean=span_ms, stats=stats,
               counters=counters, mfu_vs_paper_fsa_array=mfu, mfu_denominator=MFU_DENOMINATOR)
    emit("spec", telemetry=row)
    if not (row["verify_spans"] == stats["verify_steps"] and (k + 1) * len(drafts) == stats["draft_steps"]
            and all(e["args"]["k"] == k and e["ph"] == "X" for e in drafts)
            and row["prefill_spans"] == stats["prefill_calls"] and row["request_spans"] == len(SERVE_PROMPT_LENS)):
        raise AssertionError(f"the trace does not match the engine's steps: {row}")
    if counters != stats:
        raise AssertionError(f"registry counters {counters} != engine.stats {stats}")
    return row


def spec_greedy(cfg, prompt_lens=SPEC_GREEDY_PROMPT_LENS, policies=("none", "int8-kv-only"),
                phase: str = "spec") -> dict:
    """fp32 gate: each speculative run's tokens equal the vanilla engine's
    under the same policy, or differ first at a near-tie of the reference
    path (the greedy phase's rule).  Self-draft and the int8 draft under
    ``none``, self-draft under ``int8-kv-only`` (verify's int8 KV branch);
    every prefill, target and draft, through the simt forward."""
    params = init_params(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in prompt_lens]
    cases = [(flag, draft_quant) for flag in policies
             for draft_quant in ((None, "int8") if flag == "none" and cfg.moe is None else (None,))]
    rows, launches = [], 0
    for flag, draft_quant in cases:
        pcfg = dataclasses.replace(cfg, quant=parse_quant(flag))
        vanilla = ServeEngine(pcfg, params, batch_size=2, max_len=512, device="cuda")
        for i, p in enumerate(prompts):
            vanilla.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        ref = {r.rid: r.output for r in vanilla.run()}
        spec = SpecConfig(lookahead=SPEC_K, draft_quant=draft_quant)
        engine, done, _, counts, rounds = _spec_run(pcfg, params, prompts, spec, batch_size=2, max_len=512,
                                                    record=True)
        expected = 2 * _expected_launches(engine, prompts, pcfg)
        if counts["flash"] != dict(sm90=0, simt=expected):
            raise AssertionError(f"fp32 spec prefills launched {counts['flash']}, expected {expected} all simt")
        launches += expected
        stats = engine.stats
        if cfg.moe is not None:
            # Every verify and draft step routes dropless, one MoE call a
            # layer; prefills (target and draft) at capacity.
            moe_expected = dict(capacity=2 * cfg.num_layers * stats["prefill_calls"],
                                dropless=cfg.num_layers * (stats["verify_steps"] + stats["draft_steps"]))
            if counts["moe_calls"] != moe_expected:
                raise AssertionError(f"MoE calls {counts['moe_calls']}, expected {moe_expected}")
        first, dropped = _first_rejection(rounds, SPEC_K, 512)
        row = dict(arch=cfg.name, layers=cfg.num_layers, quant=flag,
                   draft="self" if draft_quant is None else "self@int8", lookahead=SPEC_K,
                   prompt_lens=list(prompt_lens), acceptance=engine.acceptance_rate(), stats=stats,
                   rows_dropped_past_capacity=dropped, flash_launches_by_kernel=counts["flash"],
                   **({"moe_calls": counts["moe_calls"]} if cfg.moe is not None else {}))
        if draft_quant is None and first is not None:
            rid, t = first
            tie = _near_tie(pcfg, params, np.concatenate([prompts[rid], ref[rid][:t]]))
            row["first_rejected_draft"] = dict(rid=rid, output_index=t, **tie)
        near_ties = 0
        for i, p in enumerate(prompts):
            if done[i].output == ref[i]:
                continue
            t = next(j for j, (a, b) in enumerate(zip(done[i].output, ref[i])) if a != b)
            tie = _near_tie(pcfg, params, np.concatenate([p, ref[i][:t]]))
            emit(phase, rid=i, quant=flag, draft=row["draft"], first_difference=t, **tie)
            if not tie["near_tie"]:
                raise AssertionError(f"request {i}: spec {done[i].output} != vanilla {ref[i]} ({row['draft']}, {flag})")
            near_ties += 1
        row.update(near_ties=near_ties, identical=len(prompts) - near_ties)
        emit(phase, fp32_gate=row)
        if CAPACITY_PROMPT in prompt_lens and not (
                dropped > 0 and len(done[prompt_lens.index(CAPACITY_PROMPT)].output) == 512 - CAPACITY_PROMPT + 1):
            raise AssertionError(f"the {CAPACITY_PROMPT}-token request did not run into the cache's capacity: {row}")
        rows.append(row)
    del params
    return dict(rows=rows, launches=launches)


def spec_moe() -> dict:
    """qwen3-moe at full width, depth 2, fp32, capacity_factor E / k (the
    moe phase's greedy configuration), self-draft K = 4 against the vanilla
    engine: tokens equal but at a logit or router near-tie; verify's and
    the draft's MoE calls dropless."""
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(
        full, num_layers=MOE_GREEDY_DEPTH, dtype="float32",
        moe=dataclasses.replace(full.moe, capacity_factor=full.moe.num_experts / full.moe.top_k))
    return spec_greedy(cfg, prompt_lens=GREEDY_PROMPT_LENS, policies=("none",))


# -- phase 13: the recurrent families -----------------------------------------------------

# zamba2-1.2b (38 Mamba2 layers, d_model 2048, one shared attention block of
# 32 heads of 64 before layers 0, 6, ..., 36: 7 flash calls a forward) and
# xlstm-125m (6 (mLSTM, sLSTM) pairs, d_model 768, no attention), both at
# full width and depth.  Serving: 4 requests through a 2-slot engine whose
# buckets (16, 64, 128, 256) each prefill one decode step a token.
RECURRENT_ARCHS = ("zamba2-1.2b", "xlstm-125m")
RECURRENT_PROMPT_LENS = (16, 40, 100, 200)
RECURRENT_MAX_NEW = 8
RECURRENT_ENGINE = dict(batch_size=2, max_len=256)
# The fp32 gates: zamba2 at depth 7 (two shared applications, at layers 0
# and 6), xlstm at full depth; its gradients at depth 7 on 1 x 512 (the
# simt pair at d 64).
ZAMBA2_FP32_DEPTH = 7
ZAMBA2_GRADS = dict(depth=ZAMBA2_FP32_DEPTH, batch=1, seq=512)
# xlstm trains at 2 x 256: both blocks are per-token Python loops under
# autograd and each step keeps a [B, 4, 192, 192] fp32 matrix memory.
XLSTM_TRAIN_SHAPE = ShapeConfig("chip_smoke_xlstm", 256, 2, "train")
# Decode logits against forward logits over the longest request: the
# reference's own bound (tests/test_models.py, test_zamba2_decode_matches_forward).
DECODE_VS_FORWARD_ATOL = 5e-3


# Under --quant int8 (fault F1's repair: xlstm's [768, 4] gate products pad
# their widths for _int_mm), one request: every decode step quantizes every
# weight, and the scan prefill is a decode step a bucket token.
RECURRENT_INT8_PROMPT_LENS = (16,)


def _recurrent_prompts(cfg, seed: int, lens=RECURRENT_PROMPT_LENS) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def recurrent_serve(cfg, params, prompt_lens=RECURRENT_PROMPT_LENS) -> dict:
    """The requests through ServeEngine: tokens/s, TTFT, prefill, TPOT,
    peak memory, _int_mm calls; no flash launch (the scan prefill and
    decode attend through the decode-attention kernel)."""
    prompts = _recurrent_prompts(cfg, 0, prompt_lens)
    warm = ServeEngine(cfg, params, device="cuda", **RECURRENT_ENGINE)
    warm.submit(Request(rid=-1, prompt=prompts[0], max_new_tokens=2))
    warm.run()
    del warm
    engine = ServeEngine(cfg, params, device="cuda", **RECURRENT_ENGINE)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=RECURRENT_MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_kernel = dict(flash.launch_counts)
    ttft, tpot = request_latencies(done)
    toks = sum(len(r.output) for r in done)
    row = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, quant=_quant_flag(cfg),
               prompt_lens=list(prompt_lens), buckets=[engine.bucket_for(n) for n in prompt_lens],
               requests=len(done), tokens=toks, int_mm_calls=quantize.int_mm_calls,
               seconds=dt, tokens_per_s=toks / dt, ttft_ms_p50=float(np.median(ttft)) * 1e3,
               prefill_ms_p50=float(np.median([r.t_first_token - r.t_prefill for r in done])) * 1e3,
               tpot_ms_p50=float(np.median(tpot)) * 1e3,
               # A request's TPOT also spans the other requests' prefills
               # (each seconds long); the batched decode step alone:
               decode_step_ms_p50=engine.registry.get("serve_tpot_seconds").percentile(50) * 1e3,
               flash_launches_by_kernel=by_kernel, decode_attention_launches=decode_attn.launches,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, stats=engine.stats)
    emit("recurrent", serve=row)
    if sum(by_kernel.values()) != 0:
        raise AssertionError(f"{cfg.name} serving launched flash kernels: {by_kernel}")
    if row["decode_attention_launches"] != _expected_decode_launches(engine, cfg, prompts):
        raise AssertionError(f"{cfg.name} decode attention launched {row['decode_attention_launches']} times, "
                             f"expected {_expected_decode_launches(engine, cfg, prompts)}")
    if cfg.quant is not None and row["int_mm_calls"] == 0:
        raise AssertionError(f"{cfg.name} under {row['quant']} made no _int_mm call")
    if len(done) != len(prompts) or any(len(r.output) != RECURRENT_MAX_NEW for r in done):
        raise AssertionError(f"engine finished {len(done)} requests, not all with {RECURRENT_MAX_NEW} tokens")
    return row


def _upcast(tree):
    """A params dict with every tensor in fp32 (``None`` leaves stay)."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return None if tree is None else tree.float()


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def zamba2_forward_vs_naive(cfg, params) -> dict:
    """forward on 1 x 2048 tokens through the kernel path: one sm90 launch
    an application of the shared block (counts reset before, read after).

    The whole model's bf16 logits against the naive-attention path are
    reported, not gated: the first card run read 0.0718 of the largest
    logit (argmax agreement 0.847) against TOL_PREFILL_REL, as 38 bf16
    Mamba2 layers carry a one-step difference of an attention output on to
    the logits (the moe phase's precedent, _prefill_vs_naive).  Gated
    instead: at each of the 7 applications, the kernel path's attention
    output against the naive path's on the same input (the kernel path's
    own hidden state) within TOL_PREFILL_REL; and the whole model in fp32
    (the bf16 weights upcast; the simt kernel against the naive path),
    logits within TOL_GRADS["float32"] of the largest.  Beside them, each
    bf16 path's distance from the fp32 naive logits."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    naive = dataclasses.replace(cfg, attention_impl="naive")
    torch.cuda.synchronize()
    reset_path_counts()
    with torch.no_grad():
        got = forward(params, cfg, tokens=toks)[0].float()
        torch.cuda.synchronize()
        launches = dict(flash.launch_counts)
        ref = forward(params, naive, tokens=toks)[0].float()
        shared, pos = params["shared_attn"], torch.arange(2048, device="cuda", dtype=torch.int32)[None]
        per_application, x = [], params["embed"][toks]
        for idx in range(cfg.num_layers):
            with_attn = idx % cfg.attn_every == 0
            if with_attn:
                h = apply_norm(x, shared["attn_norm"], cfg.norm_type)
                per_application.append(_rel(*(attention_forward(h, shared["attn"], c, pos).float()
                                              for c in (cfg, naive))))
            x = _hybrid_layer(x, _layer(params["mamba_layers"], idx), shared, cfg, pos, with_attn)
        fp32_cfg = dataclasses.replace(cfg, dtype="float32")
        fp32_params = _upcast(params)
        got32 = forward(fp32_params, fp32_cfg, tokens=toks)[0]
        ref32 = forward(fp32_params, dataclasses.replace(fp32_cfg, attention_impl="naive"), tokens=toks)[0]
    del fp32_params
    row = dict(arch=cfg.name, tokens=2048, launches=launches, expected=dict(sm90=_attn_layers(cfg), simt=0),
               attention_max_rel_err_by_application=per_application, tol=TOL_PREFILL_REL,
               fp32_logits_max_rel_err=_rel(got32, ref32), fp32_tol=TOL_GRADS["float32"],
               bf16_logits_max_rel_err=_rel(got, ref),
               bf16_argmax_agreement=float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
               bf16_kernel_vs_fp32_naive=_rel(got, ref32), bf16_naive_vs_fp32_naive=_rel(ref, ref32))
    emit("recurrent", forward_vs_naive=row)
    if launches != row["expected"]:
        raise AssertionError(f"zamba2 forward launched {launches}, expected {row['expected']}")
    if not (max(per_application) <= TOL_PREFILL_REL and row["fp32_logits_max_rel_err"] <= TOL_GRADS["float32"]
            and torch.isfinite(got).all()):
        raise AssertionError(f"zamba2 forward differs from the naive path: {row}")
    return row


def decode_vs_forward(cfg) -> dict:
    """fp32: decode_step over the longest request's tokens, one at a time,
    against forward's logits at the same positions."""
    params = init_params(cfg, seed=1, device="cuda")
    toks = torch.as_tensor(_recurrent_prompts(cfg, 1)[-1][None], device="cuda")
    with torch.no_grad():
        full = forward(params, cfg, tokens=toks)[0]
        cache = init_cache(cfg, 1, toks.shape[1], "cuda")
        steps = []
        for i in range(toks.shape[1]):
            logits, cache = decode_step(params, cfg, toks[:, i:i + 1], cache, i)
            steps.append(logits[0, 0])
    err = float((torch.stack(steps) - full).abs().max())
    row = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, tokens=toks.shape[1],
               max_abs_err=err, tol=DECODE_VS_FORWARD_ATOL)
    emit("recurrent", decode_vs_forward=row)
    if not err <= DECODE_VS_FORWARD_ATOL:
        raise AssertionError(f"{cfg.name} decode differs from forward: {row}")
    del params
    return row


def recurrent_phase() -> dict:
    """The recurrent-families slice on the card (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    for arch in RECURRENT_ARCHS:
        full = get_config(arch)
        params = init_params(full, seed=0, device="cuda")
        row = dict(serve=recurrent_serve(full, params))
        row["serve_int8"] = recurrent_serve(get_config(arch, "int8"), params, RECURRENT_INT8_PROMPT_LENS)
        if full.family == "hybrid":
            row["forward"] = zamba2_forward_vs_naive(full, params)
        del params
        torch.cuda.empty_cache()
        row["train"] = train(full, TRAIN_SHAPE if full.family == "hybrid" else XLSTM_TRAIN_SHAPE, "recurrent")
        torch.cuda.empty_cache()
        fp32 = dataclasses.replace(full, dtype="float32")
        if full.family == "hybrid":
            fp32 = dataclasses.replace(fp32, num_layers=ZAMBA2_FP32_DEPTH)
        row["greedy"] = greedy(fp32, "recurrent", RECURRENT_PROMPT_LENS, RECURRENT_MAX_NEW,
                               RECURRENT_ENGINE["max_len"])
        row["decode_vs_forward"] = decode_vs_forward(fp32)
        if full.family == "hybrid":
            row["grads"] = grads(full, {"float32": TOL_GRADS["float32"]}, phase="recurrent", **ZAMBA2_GRADS)
        torch.cuda.empty_cache()
        out[arch] = row
    emit("recurrent", seconds=time.perf_counter() - t0)
    return out


# -- phase 14: distribution under a 1 x 1 mesh, and the dry-run -------------------------

DIST_TRAIN_STEPS = 3


def _mesh_1x1():
    """A 1 x 1 ("data", "model") mesh over a world-size-1 NCCL group."""
    ensure_process_group(1, "cuda")
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError(f"the 1 x 1 mesh runs on {torch.distributed.get_backend()}, not NCCL")
    return make_debug_mesh(1, 1, device_type="cuda")


def _placed(cfg, mesh):
    """The seed-0 params (those of the no-mesh phases) placed on ``mesh``."""
    params = init_params(cfg, seed=0, device="cuda")
    return place(params, param_shardings(params, cfg, mesh))


def _beside(phase: str, name: str, mesh_run: dict, plain_run: dict, keys) -> None:
    emit(phase, **{name: {k: dict(mesh_1x1=mesh_run[k], no_mesh=plain_run[k],
                                  ratio=mesh_run[k] / plain_run[k] if plain_run[k] else None)
                          for k in keys}})


def dist_spec(cfg, params, mesh, specced: dict) -> dict:
    """(a) The spec phase's self-draft run (its requests, SpecConfig(lookahead=
    SPEC_K), unchunked) under the 1 x 1 mesh: the draft shares the placed
    params and places its own cache.  Tokens, acceptance and sm90 launches
    equal to the no-mesh run's; a second wave leaves the compile counts."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    spec = SpecConfig(lookahead=SPEC_K)
    _spec_run(cfg, params, prompts[:1], spec, batch_size=4, max_len=2048, mesh=mesh)  # warm-up
    engine, done, dt, counts, _ = _spec_run(cfg, params, prompts, spec, batch_size=4, max_len=2048, mesh=mesh)
    plain = next(r for r in specced["runs"] if r["draft"] == "self" and r["prefill_chunk"] is None)
    got, want = {i: r.output for i, r in done.items()}, specced["outputs"][None, None]
    run = _spec_row(cfg, engine, done, dt, counts, "self", None, mesh="x".join(map(str, mesh.shape)),
                    equal_to_no_mesh=f"{sum(got[i] == want[i] for i in want)}/{len(want)} requests")
    emit("dist", spec_self_under_mesh=run)
    _beside("dist", "olmo_spec_self", run, plain, ("ttft_ms_p50", "tpot_ms_p50", "tpot_amortized_ms_p50",
                                                   "tokens_per_s", "max_memory_allocated_gb"))
    if not isinstance(engine.draft.cache.k, DTensor):
        raise AssertionError(f"the draft cache under the mesh is a {type(engine.draft.cache.k)}, not placed")
    if got != want or run["acceptance"] != plain["acceptance"]:
        raise AssertionError(f"spec under the 1 x 1 mesh: tokens equal {run['equal_to_no_mesh']}, acceptance "
                             f"{run['acceptance']} against {plain['acceptance']}")
    if counts["flash"] != plain["flash_launches_by_kernel"]:
        raise AssertionError(f"spec under the mesh launched {counts['flash']}, no mesh "
                             f"{plain['flash_launches_by_kernel']}")
    second_wave(engine, cfg, "dist", "olmo-1b_spec_self_mesh")
    return dict(run=run, launches=counts["flash"]["sm90"])


def dist_compressed_pmean(cfg, mesh, first_loss: float) -> dict:
    """(b) ``compressed_pmean`` over the mesh's "data" group, on the gradient
    of the dist phase's first training step (the seed-0 placed params, the
    trainer's batch 0: its loss must be that step's), local tensors, with
    the residual one compression leaves: with n = 1 the average equals
    ``dequantize_int8(*quantize_int8(g + r))`` and the new residual
    ``compress_with_feedback``'s, bit for bit.  Timed with CUDA events."""
    torch.cuda.reset_peak_memory_stats()
    params = _placed(cfg, mesh)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in make_source(cfg, TRAIN_SHAPE, DataConfig(seed=0)).batch(0).items()}
    batch = place(batch, batch_pspec(batch, mesh, cfg))
    with set_mesh(mesh):
        loss, g = value_and_grad(cfg, params, batch)
    loss = float(full(loss))
    del params, batch
    torch.cuda.empty_cache()
    g = tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, g)
    _, _, r = compress_with_feedback(g, init_residual(g))
    avg, new_r = compressed_pmean(g, r, "data", mesh)
    want_avg = tree_map(lambda gi, ri: dequantize_int8(*quantize_int8(gi.float() + ri)), g, r)
    unequal = [i for i, (a, b) in enumerate(zip(tree_leaves(avg), tree_leaves(want_avg))) if not torch.equal(a, b)]
    del want_avg
    _, _, want_r = compress_with_feedback(g, r)
    unequal += [f"r{i}" for i, (a, b) in enumerate(zip(tree_leaves(new_r), tree_leaves(want_r)))
                if not torch.equal(a, b)]
    del avg, new_r, want_r
    torch.cuda.empty_cache()
    leaves = tree_leaves(g)
    n = sum(t.numel() for t in leaves)
    ms = cuda_ms(lambda: compressed_pmean(g, r, "data", mesh), iters=5, warmup=1)
    row = dict(loss=loss, first_train_loss=first_loss, leaves=len(leaves), params=n,
               grad_dtype=str(leaves[0].dtype).replace("torch.", ""), ms=ms, unequal_leaves=unequal,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("dist", compressed_pmean=row)
    if loss != first_loss:
        raise AssertionError(f"the gradient's loss {loss} is not the first training step's {first_loss}")
    if unequal:
        raise AssertionError(f"compressed_pmean differs from the quantize round trip in leaves {unequal}")
    del g, r
    torch.cuda.empty_cache()
    return row


PIPELINE_MICROBATCHES = 4


def dist_pipeline(cfg, mesh) -> dict:
    """(c) ``pipelined_apply`` over olmo-1b's stacked layers, one
    ``_transformer_block`` a stage, on a [4, 2048] input's embeddings, under
    the 1 x 1 mesh.  The mesh has no "pod" axis (the card is one rank), so
    this is the sequential schedule; the pipelined one runs only in gloo
    ranks on the CPU (tests/test_torch_pipeline.py).  Equal bit for bit to
    the model's layer loop, one sm90 launch a stage."""
    params = init_params(cfg, seed=0, device="cuda")
    b, sq = TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len
    toks = torch.as_tensor(make_source(cfg, TRAIN_SHAPE, DataConfig(seed=0)).batch(0)["tokens"], device="cuda")
    x = params["embed"][toks]
    positions = _default_positions(cfg, b, sq, x.device)

    def pipelined():
        return pipelined_apply(lambda w, h: _transformer_block(h, w, cfg, positions), params["layers"], x,
                               num_stages=cfg.num_layers, num_microbatches=PIPELINE_MICROBATCHES)

    with torch.no_grad(), set_mesh(mesh):
        torch.cuda.synchronize()
        reset_fwd_counts()
        got = pipelined()
        torch.cuda.synchronize()
        launches = dict(flash.launch_counts)
        want = x
        for layer in _unstack(params["layers"], cfg.num_layers):
            want = _transformer_block(want, layer, cfg, positions)
        ms = cuda_ms(pipelined, iters=3, warmup=1)
    row = dict(stages=cfg.num_layers, microbatches=PIPELINE_MICROBATCHES, shape=[b, sq], schedule="sequential",
               equal_to_layer_loop=bool(torch.equal(got, want)), launches=launches, ms=ms)
    emit("dist", pipelined_apply=row)
    if not row["equal_to_layer_loop"] or launches != dict(sm90=cfg.num_layers, simt=0):
        raise AssertionError(f"pipelined_apply over the layers: {row}")
    del params, x, got, want
    torch.cuda.empty_cache()
    return row


def dist_moe_serve(mesh, flag: str, want: dict) -> dict:
    """qwen3-moe-235b-a22b at depth MOE_SERVE_DEPTH under ``flag``, its
    seed-0 params placed on ``mesh``, served with the moe phase's requests
    (unchunked): tokens, MoE calls, sm90 launches and ``_int_mm`` calls
    equal to the moe phase's run ``want``."""
    with torch.no_grad():
        qcfg = dataclasses.replace(get_config(MOE_ARCH, flag), num_layers=MOE_SERVE_DEPTH)
        params = _placed(qcfg, mesh)
        out = serve(qcfg, params, "dist", mesh=mesh, chunks=(None,), vs_naive=False)
        del params
    torch.cuda.empty_cache()
    mrun, mwant = out["runs"][0], want["runs"][0]
    got, wanted = out["outputs"][None], want["outputs"][None]
    name = "moe_serve" if flag == "none" else f"moe_{flag}_serve"
    _beside("dist", name, mrun, mwant, ("ttft_ms_p50", "tpot_ms_p50", "tokens_per_s"))
    emit("dist", **{f"{name}_equal": dict(
        tokens=f"{sum(got[i] == wanted[i] for i in wanted)}/{len(wanted)} requests",
        **{k: dict(mesh_1x1=mrun[k], no_mesh=mwant[k])
           for k in ("moe_calls", "flash_launches_by_kernel", "int_mm_calls")})})
    for k in ("moe_calls", "flash_launches_by_kernel", "int_mm_calls"):
        if mrun[k] != mwant[k]:
            raise AssertionError(f"qwen3-moe under {flag} and the 1 x 1 mesh: {k} {mrun[k]} != {mwant[k]}")
    if got != wanted:
        raise AssertionError(f"qwen3-moe under {flag} and the 1 x 1 mesh served other tokens")
    return out


def dist_phase(served: dict, trained: dict, moe_served: dict, specced: dict) -> dict:
    """The distribution slice on the card (see the module docstring)."""
    t0 = time.perf_counter()
    mesh = _mesh_1x1()
    out = {}
    with torch.no_grad():
        cfg = get_config("olmo-1b")
        params = _placed(cfg, mesh)
        leaf = params["layers"]["attn"]["wq"]
        if not isinstance(leaf, DTensor) or leaf.device.type != "cuda":
            raise AssertionError(f"params not placed as DTensors on the card: {type(leaf)}")
        out["serve"] = serve(cfg, params, "dist", mesh=mesh, chunks=(None,), vs_naive=False, waves=True)
        out["spec"] = dist_spec(cfg, params, mesh, specced)
        del params
    torch.cuda.empty_cache()
    got, want = out["serve"]["outputs"][None], served["outputs"][None]
    _beside("dist", "olmo_serve", out["serve"]["runs"][0], served["runs"][0],
            ("ttft_ms_p50", "tpot_ms_p50", "prefill_ms_p50", "tokens_per_s", "max_memory_allocated_gb"))
    emit("dist", olmo_tokens_equal=f"{sum(got[i] == want[i] for i in want)}/{len(want)} requests")
    if got != want:
        raise AssertionError(f"olmo-1b under the 1 x 1 mesh served other tokens: {got} != {want}")
    if out["serve"]["runs"][0]["flash_launches_by_kernel"] != served["runs"][0]["flash_launches_by_kernel"]:
        raise AssertionError("the 1 x 1 mesh's forward launches differ from the no-mesh run's")

    out["train"] = train(get_config("olmo-1b"), TRAIN_SHAPE, "dist", steps=DIST_TRAIN_STEPS, mesh=mesh)
    torch.cuda.empty_cache()
    want_losses = trained["losses"][:DIST_TRAIN_STEPS]
    emit("dist", olmo_train_losses=dict(mesh_1x1=out["train"]["losses"], no_mesh=want_losses),
         olmo_train_step_s=dict(mesh_1x1=out["train"]["step_seconds"], no_mesh=trained["step_seconds"]))
    if out["train"]["losses"] != want_losses:
        raise AssertionError(f"losses under the 1 x 1 mesh differ: {out['train']['losses']} != {want_losses}")
    want_launches = {k: v * DIST_TRAIN_STEPS // TRAIN_STEPS for k, v in trained["launches"].items()}
    if out["train"]["launches"] != want_launches or not out["train"]["launches"]["flash_bwd_sm90_dkv"]:
        raise AssertionError(f"training launches {out['train']['launches']}, no-mesh {want_launches}")
    out["compressed_pmean"] = dist_compressed_pmean(get_config("olmo-1b"), mesh, out["train"]["losses"][0])
    out["pipeline"] = dist_pipeline(get_config("olmo-1b"), mesh)

    out["moe_serve"] = dist_moe_serve(mesh, "none", moe_served["none"])
    out["moe_int8_serve"] = dist_moe_serve(mesh, "int8", moe_served["int8"])
    torch.distributed.destroy_process_group()

    # The dry-run's prediction for the train phase's step, on a 1 x 1 mesh
    # of a fake group, beside the step the card measured.
    with fake_process_group(1):
        fake = torch.distributed.device_mesh.init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cell = lower_cell("olmo-1b", TRAIN_SHAPE, fake, scan_unroll=1)
        terms = analyze_trace(cell.cost, 1)
        bytes_per_device = cell.arg_bytes + cell.cost.peak - cell.donated_bytes
        out["predicted"] = dict(t_compute_s=terms.t_compute, t_memory_s=terms.t_memory,
                                t_collective_s=terms.t_collective, flops=terms.flops,
                                bytes_per_device_gb=bytes_per_device / 1e9, trace_s=cell.trace_s)
        # The serve phase's batched decode step (4 slots, 2048 rows): the
        # DTensor ops it dispatches beside the local ops it runs.
        step = lower_cell("olmo-1b", ShapeConfig("decode", 2048, 4, "decode"), fake)
        out["decode_ops"] = dict(dtensor_ops=step.cost.dtensor_ops, local_ops=step.cost.local_ops)
    emit("dist", olmo_train_predicted=out["predicted"],
         olmo_train_measured=dict(step_s=trained["step_s"], max_memory_allocated_gb=trained["max_memory_allocated_gb"]),
         olmo_train_ops=dict(dtensor_ops=cell.cost.dtensor_ops, local_ops=cell.cost.local_ops),
         olmo_decode_step_ops=out["decode_ops"])
    # The production path: one cell on the 16 x 16 mesh of a 256-rank fake group.
    with fake_process_group(256):
        out["dryrun"] = run_cell("olmo-1b", "train_4k", multi_pod=False, verbose=False)
    emit("dist", dryrun_olmo_train_4k_16x16={k: out["dryrun"][k] for k in (
        "status", "lower_s", "compile_s", "gb_per_device", "hlo_flops", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "useful_flops_ratio", "collective_breakdown")})
    if out["dryrun"]["status"] != "ok":
        raise AssertionError(f"dry-run cell failed: {out['dryrun']}")
    out["seconds"] = time.perf_counter() - t0
    emit("dist", seconds=out["seconds"])
    return out


# -- phase 10: the autotuner ------------------------------------------------------------

TUNE_PRESETS = ("paper", "full")


def _device_ms(prof) -> float:
    return sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3


def tune() -> dict:
    """Both presets through repro_torch.tune on the card at the launcher's
    defaults, each timed on the host clock and traced for its device time;
    the PWL kernel's launches over the two runs."""
    tune_objectives._accuracy_cached.cache_clear()
    tune_objectives._pwl_stats_cached.cache_clear()
    cpu_mre = pwl_error_stats(8)["mre"]
    reports, seconds, device_ms = {}, {}, {}
    torch.cuda.synchronize()
    pwl.launch_count = 0
    for preset in TUNE_PRESETS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reports[preset] = run_tune(preset, device="cuda")
            torch.cuda.synchronize()
            seconds[preset] = time.perf_counter() - t0
        device_ms[preset] = _device_ms(prof)
    launches = pwl.launch_count
    segments = sorted({r["pwl_segments"] for rep in reports.values() for r in rep["records"]} | {8})
    for preset, rep in reports.items():
        emit("tune", preset=preset, seconds=seconds[preset], device_ms=device_ms[preset],
             device_share=device_ms[preset] / 1e3 / seconds[preset],
             points=rep["num_points"], mesh_devices=rep["mesh_devices"],
             per_device_counts=rep["per_device_counts"], frontier_size=rep["frontier_size"],
             accuracy_seq=rep["accuracy_seq"], paper=rep["paper"],
             paper_checks_ok=rep["paper_checks_ok"], sim_checks_ok=rep["sim_checks_ok"],
             pwl_mre_8seg=rep["paper"]["pwl_mre"], pwl_mre_8seg_cpu=cpu_mre)
        if not (rep["paper_checks_ok"] and rep["sim_checks_ok"]):
            raise AssertionError(f"tune {preset}: checks failed: {rep['paper_checks']} {rep['sim_checks']}")
        if rep["paper"]["pwl_mre"] != cpu_mre:
            raise AssertionError(f"tune {preset}: Fig. 12 MRE {rep['paper']['pwl_mre']} != CPU {cpu_mre}")
    emit("tune", pwl_launches=launches, expected=len(segments), segments=segments)
    if launches != len(segments):
        raise AssertionError(f"pwl_exp2 launched {launches} times, expected {len(segments)} ({segments})")
    return dict(launches=launches, seconds=seconds)

SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_sm90_dq_kernel", "flash_bwd_sm90_dkv_kernel")


def _ptxas_frames(log: str, entry_pattern: str, fields) -> list[dict]:
    """Registers, stack and spills of each kernel instantiation whose
    mangled name ``entry_pattern`` matches in ptxas -v's report; ``fields``
    turns the match into the row's first keys."""
    rows, row = [], None
    for line in log.splitlines():
        entry = re.search(rf"Compiling entry function '\S*{entry_pattern}", line)
        if entry:
            row = fields(entry)
            rows.append(row)
            continue
        if row is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if frame:
            row.update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                       spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            row["registers"] = int(used.group(1))
            row = None
    return rows


def sm90_ptxas(log: str) -> list[dict]:
    """Registers, stack and spills of each tensor-core kernel instantiation
    (flash_fwd_sm90_kernel<D, PWL>, flash_bwd_sm90_{dq,dkv}_kernel<D>), from
    ptxas -v in a build log."""
    def fields(entry):
        row = dict(kernel=entry.group(1), head_dim=int(entry.group(2)))
        if entry.group(3) is not None:
            row["pwl"] = entry.group(3) == "1"
        return row
    names = "|".join(SM90_KERNELS)
    return _ptxas_frames(log, rf"({names})ILi(\d+)E(?:Lb([01])E)?", fields)


def simt_ptxas(log: str) -> list[dict]:
    """Registers, stack and spills of each SIMT forward instantiation
    (flash_fwd_kernel<T, D, BQ>, T float or __nv_bfloat16), from ptxas -v."""
    def fields(entry):
        return dict(kernel="flash_fwd_kernel", dtype="float32" if entry.group(1) == "f" else "bfloat16",
                    head_dim=int(entry.group(2)), q_tile=int(entry.group(3)))
    return _ptxas_frames(log, r"16flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", fields)


def simt_bwd_ptxas(log: str) -> list[dict]:
    """Registers, stack and spills of each SIMT backward instantiation
    (flash_bwd_dq_kernel<T, D, R> and flash_bwd_dkv_kernel<T, D, R>, R the
    resident tile), from ptxas -v."""
    def fields(entry):
        return dict(kernel=entry.group(1)[2:], dtype="float32" if entry.group(2) == "f" else "bfloat16",
                    head_dim=int(entry.group(3)), tile=int(entry.group(4)))
    return _ptxas_frames(
        log, r"(19flash_bwd_dq_kernel|20flash_bwd_dkv_kernel)I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", fields)


def simt_bwd_ctas_per_sm(rows: list[dict]) -> None:
    """Add to each row of ``simt_bwd_ptxas`` the CTAs of that instantiation
    an SM holds at once (flash_bwd_ctas_per_sm: the occupancy API, with the
    kernel's shared memory)."""
    fn = flash_bwd._library(flash_bwd.SIMT.library).flash_bwd_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for row in rows:
        ctas = ctypes.c_int(0)
        err = fn(int(row["kernel"] == "flash_bwd_dq_kernel"), flash._DTYPE_CODES[getattr(torch, row["dtype"])],
                 row["head_dim"], row["tile"], ctypes.byref(ctas))
        if err:
            raise RuntimeError(f"flash_bwd_ctas_per_sm failed for {row}: error {err}")
        row["ctas_per_sm"] = ctas.value


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        sys.exit(1)
    # (d) every kernel library nvcc builds from here on, counted by phase.
    watcher, builds = JitCompileWatcher().install(), {}

    def built(phase: str) -> None:
        builds[phase] = watcher.count - sum(builds.values())

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
    built("build")
    emit("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in libs.values()],
         ptxas=ptxas, nvcc_builds=builds["build"])
    if sys.argv[1:] == ["--time-simt"]:
        time_flash_simt()
        time_simt_bwd(full=False)
        return
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--time-simt]")
    sm90 = sm90_ptxas(libs["flash_fwd_sm90"].with_suffix(".log").read_text())
    sm90_bwd = sm90_ptxas(libs["flash_bwd_sm90"].with_suffix(".log").read_text())
    simt = simt_ptxas(libs["flash_fwd"].with_suffix(".log").read_text())
    simt_bwd = simt_bwd_ptxas(libs["flash_bwd"].with_suffix(".log").read_text())
    simt_bwd_ctas_per_sm(simt_bwd)
    # flash_fwd_kernel<T, D, BQ>: each (dtype, head_dim) KERNELS gives it, each q tile;
    # flash_bwd_{dq,dkv}_kernel<T, D, R>: each (dtype, head_dim) BWD_KERNELS gives the
    # simt pair, each resident tile.
    simt_instances = len(flash.SIMT_Q_TILES) * sum(k is flash.SIMT for k in flash.KERNELS.values())
    simt_bwd_instances = 2 * len(flash_bwd.SIMT_BWD_TILES) * sum(
        k is flash_bwd.SIMT for k in flash_bwd.BWD_KERNELS.values())
    # d = 64 is on a main path since zamba2 (its spills printed on their own):
    # no sm90 forward instantiation may spill.
    d64_spills = [dict(pwl=r.get("pwl"), registers=r.get("registers"), spill_stores=r["spill_stores"],
                       spill_loads=r["spill_loads"]) for r in sm90 if r["head_dim"] == 64]
    emit("build", flash_fwd_sm90=sm90, flash_fwd_sm90_d64_spills=d64_spills, flash_bwd_sm90=sm90_bwd,
         flash_fwd=simt, flash_bwd=simt_bwd)
    if len(sm90) != 4 or any(r["spill_stores"] or r["spill_loads"] for r in sm90):
        raise AssertionError(f"flash_fwd_sm90 instantiations missing or spilling: {sm90}")
    if len(sm90_bwd) != 4 or any(r["spill_stores"] or r["spill_loads"] for r in sm90_bwd):
        raise AssertionError(f"flash_bwd_sm90 instantiations missing or spilling: {sm90_bwd}")
    if len(simt) != simt_instances or any(r["spill_stores"] or r["spill_loads"] for r in simt):
        raise AssertionError(f"flash_fwd (simt) instantiations missing or spilling: {simt}")
    if len(simt_bwd) != simt_bwd_instances or any(r["spill_stores"] or r["spill_loads"] for r in simt_bwd):
        raise AssertionError(f"flash_bwd (simt) instantiations missing or spilling: {simt_bwd}")

    sweep_err = check_flash_sweep()
    check_pwl_subnormal_range()
    built("kernels")
    timing = time_flash()
    simt_timing = time_flash_simt()
    simt_q_tiles = time_simt_q_tiles()
    bwd_err = check_bwd_sweep()
    built("kernels_bwd")
    bwd_timing = time_bwd()
    pwl_compared, pwl_err = check_pwl()
    pwl_timing = time_pwl()
    built("kernels_pwl")
    decode_err = check_decode_sweep()
    decode_timing = time_decode()
    decode_splits = time_decode_splits()
    built("kernels_decode")

    cfg = get_config("olmo-1b")
    params = init_params(cfg, seed=0, device="cuda")
    served = serve(cfg, params, waves=True)
    built("serve")
    specced = spec_serve(cfg, params, served["outputs"])
    built("spec")
    del params
    torch.cuda.empty_cache()
    greedied = greedy(dataclasses.replace(cfg, dtype="float32"))
    built("greedy")
    torch.cuda.empty_cache()
    spec_greedied = spec_greedy(dataclasses.replace(cfg, dtype="float32"))
    built("spec_greedy")
    torch.cuda.empty_cache()
    trained = train(cfg)
    built("train")
    torch.cuda.empty_cache()
    graded = grads(cfg)
    built("grads")
    torch.cuda.empty_cache()
    moed = moe_phase()
    spec_moed = spec_moe()
    built("moe")
    torch.cuda.empty_cache()
    recurrent = recurrent_phase()
    built("recurrent")
    torch.cuda.empty_cache()
    disted = dist_phase(served, trained, moed["served"], specced)
    built("dist")
    torch.cuda.empty_cache()
    tuned = tune()
    built("tune")
    watcher.uninstall()
    emit("builds", nvcc_builds_by_phase=builds)
    if any(n for phase, n in builds.items() if phase != "build"):
        raise AssertionError(f"kernel libraries were built after the build phase: {builds}")

    serve_shape = next(r for r in timing if r["shape"] == [1, 2048, 16, 128])
    zamba2 = recurrent["zamba2-1.2b"]
    fwd_launches = dict(serve=served["launches"], spec_serve=specced["launches"],
                        train=trained["launches"]["flash_fwd"],
                        grads_bfloat16=graded["fwd_launches"]["bfloat16"]["sm90"],
                        **{f"moe_serve_{flag}": run["launches"] for flag, run in moed["served"].items()},
                        arctic_prefill=moed["arctic"]["launches"],
                        zamba2_forward=zamba2["forward"]["launches"]["sm90"],
                        zamba2_train=zamba2["train"]["launches"]["flash_fwd"],
                        dist_serve=disted["serve"]["launches"],
                        dist_spec_serve=disted["spec"]["launches"],
                        dist_train=disted["train"]["launches"]["flash_fwd"],
                        dist_moe_serve=disted["moe_serve"]["launches"],
                        dist_moe_int8_serve=disted["moe_int8_serve"]["launches"],
                        dist_pipeline=disted["pipeline"]["launches"]["sm90"])
    greedy_shape = next(r for r in simt_timing if r["shape"] == [1, 256, 16, 128])
    simt_launches = dict(greedy=greedied["launches"], grads_float32=graded["fwd_launches"]["float32"]["simt"],
                         moe_greedy=moed["greedy"]["launches"], spec_greedy=spec_greedied["launches"],
                         spec_moe=spec_moed["launches"],
                         moe_grads_float32=moed["grads"]["fwd_launches"]["float32"]["simt"],
                         zamba2_grads_float32=zamba2["grads"]["fwd_launches"]["float32"]["simt"])
    # zamba2's d 64 beside olmo's d 128 at equal work ([4, 2048] causal,
    # 32 x 64 against 16 x 128), device time.
    d64 = next(r for r in timing if r["shape"] == [4, 2048, 32, 64])
    d128 = next(r for r in timing if r["shape"] == [4, 2048, 16, 128])
    emit("kernels", d64_vs_d128=dict(
        forward_device_ms=[d64["device_ms"], d128["device_ms"]],
        backward_whole_device_ms=[bwd_timing["sm90_d64"]["whole"]["device_ms"], bwd_timing["sm90"]["whole"]["device_ms"]],
        **{f"backward_{k}_device_ms": [bwd_timing["sm90_d64"][k]["device_ms"], bwd_timing["sm90"][k]["device_ms"]]
           for k in ("dq", "dkv")}))
    # The forward's two kernels, both ports of _fwd_kernel: the sm90 one on
    # the bf16 main path (serve, train), the simt one on the fp32 greedy path.
    records = [dict(
        name="flash_fwd", variant="sm90: wgmma + TMA, producer/consumer warpgroups (bf16, d 64 and 128)",
        route="cuda", source="src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:64",
        launches=sum(fwd_launches.values()), launches_by_path=fwd_launches,
        max_abs_err=sweep_err["sm90"], max_abs_err_fp32_p=sweep_err["sm90_vs_fp32_p"],
        tol={"bfloat16": TOL[torch.bfloat16], "bfloat16_vs_fp32_p": TOL_FP32P},
        ms=serve_shape["ms"], plain_ms=serve_shape["plain_ms"],
        bound_ms=serve_shape["bound_ms"], bound_by=serve_shape["bound_by"],
        library_ms=serve_shape["library_ms"], shape=serve_shape["shape"], by_shape=timing,
        ptxas=sm90, d64_spills=d64_spills,
    ), dict(
        name="flash_fwd_simt",
        variant="simt: register-blocked fp32 FMAs on the CUDA cores, staggered cp.async loads, two CTAs an SM, "
                "q tile 32 or 16 (fp32; bf16 at d 16 and 32)",
        route="cuda", source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:64",
        launches=sum(simt_launches.values()), launches_by_path=simt_launches,
        max_abs_err=sweep_err["simt"],
        tol={"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16], "lse": TOL_LSE},
        ms=greedy_shape["ms"], device_ms=greedy_shape["device_ms"], plain_ms=greedy_shape["plain_ms"],
        bound_ms=greedy_shape["bound_ms"], bound_by=greedy_shape["bound_by"],
        library_ms=greedy_shape["library_ms"], library_device_ms=greedy_shape["library_device_ms"],
        library_kernels=greedy_shape["library_kernels"], shape=greedy_shape["shape"],
        by_shape=simt_timing, by_q_tile=simt_q_tiles, ptxas=simt,
    )]
    # Each backward kernel is timed alone; the plain version and SDPA's
    # backward compute dQ, dK and dV together, so theirs are the whole's.
    # The sm90 pair runs on the bf16 main path (train; the bf16 gradient
    # check), the simt pair on the fp32 gradient check (its records at that
    # shape, every timed shape in by_shape).
    simt_grads = next(r for r in bwd_timing["simt"] if r["shape"] == [GRADS_BATCH, GRADS_SEQ, 16, 128])
    bwd_pairs = (
        ("", flash_bwd.SM90, "sm90: wgmma + TMA, producer/consumer warpgroups (bf16, d 64 and 128)",
         "flash_bwd_sm90.cu", dict(train=trained["launches"], grads_bfloat16=graded["launches"]["bfloat16"],
                                   zamba2_train=zamba2["train"]["launches"], dist_train=disted["train"]["launches"]),
         {"bfloat16": TOL_BWD[torch.bfloat16], "bfloat16_flips": TOL_BWD_FLIPS,
          "bfloat16_vs_fp32_p": TOL_BWD_FP32P}, bwd_timing["sm90"], sm90_bwd,
         dict(by_shape=[bwd_timing[k] for k in ("sm90", "sm90_rep16", "sm90_d64")])),
        ("_simt", flash_bwd.SIMT,
         "simt: register-blocked fp32 FMAs on the CUDA cores, staggered cp.async loads, two CTAs an SM, "
         "resident tile 32 or 16 (fp32; bf16 at d 16 and 32)",
         "flash_bwd.cu", dict(grads_float32=graded["launches"]["float32"],
                              moe_grads_float32=moed["grads"]["launches"]["float32"],
                              zamba2_grads_float32=zamba2["grads"]["launches"]["float32"]),
         {"float32": TOL_BWD[torch.float32], "bfloat16": TOL_BWD[torch.bfloat16]}, simt_grads, simt_bwd,
         dict(by_shape=bwd_timing["simt"], by_tile=bwd_timing["simt_tiles"])),
    )
    for suffix, pair, variant, source, by_path, tol, timing, ptxas_rows, more in bwd_pairs:
        for key, entry, line in (("dq", pair.entries[0], 48), ("dkv", pair.entries[1], 81)):
            row = timing[key]
            launches_by_path = {path: counts[entry] for path, counts in by_path.items()}
            extra = ({"max_abs_err_fp32_p": bwd_err[pair.name, key + "_fp32_p"]}
                     if pair is flash_bwd.SM90 else {})
            records.append(dict(
                name=f"flash_bwd_{key}{suffix}", variant=variant, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=f"src/repro/kernels/flash_attention/kernel_bwd.py:{line}",
                launches=sum(launches_by_path.values()), launches_by_path=launches_by_path,
                max_abs_err=bwd_err[pair.name, key], **extra, tol=tol,
                ms=row["ms"], device_ms=row["device_ms"], alone_device_ms=row["alone_device_ms"],
                plain_ms=timing["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=timing["library_ms"], library_device_ms=timing["library_device_ms"],
                shape=timing["shape"], dtype=timing["dtype"], whole_backward=timing["whole"],
                ptxas=[r for r in ptxas_rows if r["kernel"] == f"{entry}_kernel"], **more,
            ))
    path_size = next(r for r in pwl_timing if r["elements"] == PWL_SIZES[0])
    records.append(dict(
        name="pwl_exp2", route="cuda", source="src/repro_torch/kernels/csrc/pwl_exp2.cu",
        replaces="src/repro/kernels/pwl_exp2/kernel.py:23",
        launches=tuned["launches"], launches_by_path=dict(tune=tuned["launches"]),
        max_abs_err=pwl_err, tol="bit-equal", elements_compared=pwl_compared,
        ms=path_size["ms"], plain_ms=path_size["plain_ms"], bound_ms=path_size["bound_ms"],
        bound_by=path_size["bound_by"],
        # No single PyTorch call computes the PWL exp2; torch.exp2 on the
        # same tensor is in by_size as a bandwidth reference.
        library_ms=None, elements=path_size["elements"], by_size=pwl_timing,
    ))
    # Replaces no TPU kernel: the reference's decode attention is a
    # jnp.einsum pair (src/repro/models/attention.py:319-329).
    decode_full = next(r for r in decode_timing if r["lengths"] == "full")
    decode_by_path = dict(serve=served["decode_launches"], spec_serve=specced["decode_launches"],
                          greedy=greedied["decode_launches"])
    records.append(dict(
        name="decode_attention",
        variant="simt: rows split across CTAs, 16-byte register loads of bf16/fp32, fp32 online softmax, "
                "a combine kernel over the splits",
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu", replaces=None,
        launches=sum(decode_by_path.values()), launches_by_path=decode_by_path,
        max_err_of_largest=decode_err, tol=TOL_DECODE,
        ms=decode_full["ms"], device_ms=decode_full["device_ms"], plain_ms=decode_full["plain_ms"],
        bound_ms=decode_full["bound_ms"], bound_by=decode_full["bound_by"],
        library_ms=decode_full["library_ms"], library_device_ms=decode_full["library_device_ms"],
        library_kernels=decode_full["library_kernels"], shape=decode_full["shape"], by_lengths=decode_timing,
        splits=decode_splits,
    ))
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
