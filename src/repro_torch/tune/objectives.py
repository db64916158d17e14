"""Objective evaluators for FSA design points.

Three objectives per point, each reusing the repo's paper-reproduction
machinery and cross-checked against the paper's published numbers at the
paper's design point (see ``PAPER_TARGETS`` and ``tests/test_tune.py``):

  * **performance** — mean attention FLOPs/s utilization over the Fig. 11
    sequence sweep from ``core.systolic_model`` (closed-form §3.5 cycle
    counts), achieved TFLOP/s at the point's clock, and mean speedup vs
    the modelled TPUv5e / NeuronCore-v2 baselines (paper: 1.77x / 4.83x);
  * **accuracy** — end-to-end FlashAttention error on the Table 2 input
    distribution through ``quantized_systolic_attention``, a vectorized
    numpy twin of the instruction-level ``fsa_sim`` arithmetic (fp16
    operands/activations, fp32 accumulation, the point's PWL exp2) — the
    twin is asserted bit-compatible with ``fsa_flash_attention`` in the
    tests — plus the apparatus-independent Fig. 12 PWL exp2 error
    (exhaustive over negative normal fp16, MRE 2.728e-2 at 8 segments);
  * **area** — the Table 3 component model generalized over the design
    axes: per-PE / upward-path / split-unit areas scale with N^2, the CMP
    row with N, the split-unit LUT share with the segment count, logic
    area with the clock target, plus an SRAM estimate for the scratchpad
    and accumulation capacities.  At the paper point it reproduces
    Table 3 exactly (28,157,816 um^2 array total, 12.07% overhead).

Note on Table 2 absolute errors: our simulator (and therefore this twin)
keeps fp32 inter-PE partial sums, where the paper's RTL quantizes more
aggressively, so our MAE is *smaller* than the paper's (6.5e-5 vs 7.98e-3
at seq 2048); the paper's error envelope (MAE <= 3.4e-2, MRE <= 7.2e-2)
is the bound that transfers, and the Fig. 12 PWL error is the sharp
8-segment cross-check.

A copy of ``repro.tune.objectives``.  ``quantized_systolic_attention`` and
the Table 2 evaluation stay numpy on the host, as in the reference; the
Fig. 12 sweep (``core.pwl_exp2.pwl_error_stats``) runs on ``device``
through the PWL exp2 kernel, which takes its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.pwl_exp2 import LOG2_E, pwl_error_stats, segment_table
from repro_torch.core.systolic_model import (
    PAPER_SEQLENS,
    attention_flops,
    baseline_utilization,
    fsa_attention_cycles,
    fsa_utilization,
)
from repro_torch.kernels.pwl_exp2.kernel import pwl_exp2_cuda

from .design import DesignPoint

__all__ = [
    "PAPER_TARGETS",
    "quantized_systolic_attention",
    "eval_performance",
    "eval_accuracy",
    "eval_area",
    "evaluate",
]

# Published numbers the evaluators must land on at the paper's design point.
PAPER_TARGETS = {
    "speedup_vs_tpu_v5e": 1.77,      # Fig. 11
    "speedup_vs_neuron_v2": 4.83,    # Fig. 11
    "area_total_um2": 28_157_816.0,  # Table 3 (sum of all components)
    "overhead_pct": 12.07,           # Table 3
    "pwl_mre_8seg": 0.02728,         # Fig. 12, 8 segments
    "table2_mae_envelope": 3.40e-2,  # Table 2 worst MAE (seq 16384)
    "table2_mre_envelope": 7.20e-2,  # Table 2 worst MRE
}

# ---------------------------------------------------------------------------
# Performance (core.systolic_model closed forms)
# ---------------------------------------------------------------------------

def eval_performance(point: DesignPoint, seqlens=PAPER_SEQLENS) -> dict:
    """Mean utilization / TFLOP/s / baseline speedups at head_dim = N."""
    n = point.array_n
    utils = [
        fsa_utilization(s, n, n, single_direction=point.single_direction)
        for s in seqlens
    ]
    mean_util = float(np.mean(utils))
    peak_tflops = point.peak_flops_per_cycle * point.freq_ghz * 1e9 / 1e12
    base = {
        which: float(np.mean([baseline_utilization(which, s, n) for s in seqlens]))
        for which in ("tpu_v5e", "neuron_v2")
    }
    return {
        "mean_util": mean_util,
        "mean_tflops": mean_util * peak_tflops,
        "peak_tflops": peak_tflops,
        "speedup_vs_tpu_v5e": mean_util / base["tpu_v5e"],
        "speedup_vs_neuron_v2": mean_util / base["neuron_v2"],
        "cycles_max_seq": fsa_attention_cycles(
            max(seqlens), n, n, single_direction=point.single_direction
        ),
        "flops_max_seq": attention_flops(max(seqlens), n),
    }


# ---------------------------------------------------------------------------
# Accuracy (Table 2 protocol through the fsa_sim-equivalent numpy twin)
# ---------------------------------------------------------------------------

def quantized_systolic_attention(
    q: np.ndarray,  # [seq, d] fp16
    k: np.ndarray,  # [seq, d] fp16
    v: np.ndarray,  # [seq, d] fp16
    *,
    array_n: int,
    num_segments: int,
) -> np.ndarray:
    """Vectorized twin of the ``fsa_sim`` AttnScore/AttnValue arithmetic.

    Identical op order and precision to ``FSADevice._op_attn_score`` /
    ``_op_attn_value`` — fp16 S leaving the array top, fp16 P resident in
    the PEs, fp32 accumulation, PWL exp2 on fp32 MACs — but evaluated for
    all Q rows at once instead of per instruction, so a seq-2048 Table 2
    measurement takes ~0.7 s instead of minutes.
    """
    seq, d = q.shape
    assert seq % array_n == 0, (seq, array_n)
    slope, intercept = segment_table(num_segments)

    def pwl(x32: np.ndarray) -> np.ndarray:
        x_i = np.ceil(x32)
        x_f = x32 - x_i
        idx = np.clip(
            np.floor((x_f + 1.0) * num_segments).astype(np.int32),
            0, num_segments - 1,
        )
        frac = slope[idx] * x_f + intercept[idx]
        out = np.ldexp(frac, np.clip(x_i, -150, 127).astype(np.int32))
        out[x_i < -148] = 0.0
        return out.astype(np.float32)

    scale = 1.0 / float(np.sqrt(d))
    c = np.float16(scale * LOG2_E)
    qt = np.ascontiguousarray(q.T)  # [d, seq], stationary layout
    vt = np.ascontiguousarray(v.T)  # [d, seq]
    old_m = np.full((seq,), -np.inf, np.float32)
    l_acc = np.zeros((seq,), np.float32)
    o_acc = np.zeros((d, seq), np.float32)
    for j0 in range(0, seq, array_n):
        kt = k[j0 : j0 + array_n].astype(np.float32)  # [Bc, d]
        s = (kt @ qt.astype(np.float32)).astype(np.float16)  # [Bc, seq]
        local_m = s.max(axis=0)
        new_m = np.maximum(local_m, old_m.astype(np.float16))
        a = np.maximum((old_m.astype(np.float16) - new_m).astype(np.float32), -1e4)
        b = pwl(np.float32(c) * a)
        n_mat = (s - new_m[None, :]).astype(np.float16)
        p = pwl((c * n_mat).astype(np.float32)).astype(np.float16)
        l_acc = l_acc * b + p.astype(np.float32).sum(axis=0)
        o_acc = o_acc * b[None, :] + vt[:, j0 : j0 + array_n].astype(np.float32) @ p.astype(
            np.float32
        )
        old_m = new_m.astype(np.float32)
    recip = np.where(l_acc == 0, 0.0, 1.0 / l_acc).astype(np.float32)
    return np.ascontiguousarray((o_acc * recip[None, :]).T)


def _draw_table2(rng: np.random.Generator, shape) -> np.ndarray:
    """The paper's Table 2 heavy-tail input distribution (FA-3 protocol)."""
    x = rng.standard_normal(shape) + rng.standard_normal(shape) * 10.0 * (
        rng.random(shape) < 0.001
    )
    return x.astype(np.float16)


@functools.lru_cache(maxsize=None)
def _accuracy_cached(array_n: int, num_segments: int, seq: int, seed: int) -> dict:
    rng = np.random.default_rng((seed, array_n, seq))
    shape = (seq, array_n)  # FSA maps head_dim = N (paper §3.5)
    q, k, v = (_draw_table2(rng, shape) for _ in range(3))
    approx = quantized_systolic_attention(
        q, k, v, array_n=array_n, num_segments=num_segments
    ).astype(np.float64)
    qf, kf, vf = (a.astype(np.float64) for a in (q, k, v))
    s = qf @ kf.T / np.sqrt(array_n)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    exact = p @ vf
    diff = np.abs(approx - exact)
    return {
        "acc_mae": float(diff.mean()),
        "acc_mre": float((diff / (np.abs(exact) + 1e-9)).mean()),
        "acc_seq": float(seq),
    }


@functools.lru_cache(maxsize=None)
def _pwl_stats_cached(num_segments: int, device: str) -> tuple[float, float]:
    # Keyed on the device too: a CPU result must not stand in for the card's.
    def on_device(x: torch.Tensor, k: int) -> torch.Tensor:
        return pwl_exp2_cuda(x.to(device), num_segments=k)

    stats = pwl_error_stats(num_segments, on_device)
    return stats["mae"], stats["mre"]


def eval_accuracy(
    point: DesignPoint, *, seq: int = 2048, seed: int = 0, device: str = "cuda"
) -> dict:
    """Table 2 end-to-end error + Fig. 12 PWL intrinsic error.

    ``seq`` is rounded up to a multiple of the array size (tile
    granularity); results are cached per (N, segments, seq, seed) — the
    objective depends only on those axes, so grid sweeps pay for each
    distinct combination once.  The Fig. 12 sweep runs on ``device``.
    """
    n = point.array_n
    seq = -(-seq // n) * n
    out = dict(_accuracy_cached(n, point.pwl_segments, seq, seed))
    pwl_mae, pwl_mre = _pwl_stats_cached(point.pwl_segments, str(device))
    out["pwl_mae"] = pwl_mae
    out["pwl_mre"] = pwl_mre
    return out


# ---------------------------------------------------------------------------
# Area (Table 3 component model, generalized)
# ---------------------------------------------------------------------------

PAPER_N = 128
# Paper Table 3 component areas at N = 128, 16 nm, 1.5 GHz (um^2).
PAPER_AREA = {
    "pes": 24_445_044.0,
    "other": 313_457.0,
    "upward": 1_756_641.0,
    "split": 1_493_150.0,
    "cmp": 149_524.0,
}
# Share of the split unit that is the PWL coefficient LUT (scales with the
# segment count; the splitter/MAC half does not).  Estimate — chosen so the
# 8-segment point reproduces Table 3 exactly and the area cost of segment
# count is visible to the tuner.
SPLIT_LUT_FRACTION = 0.5
# 16 nm SRAM density estimate incl. periphery: ~0.15 um^2/bit.
SRAM_UM2_PER_KIB = 1200.0
# Logic area vs synthesis clock: relative slope per GHz around the paper's
# 1.5 GHz target (larger drive strengths at tighter timing).  Estimate.
FREQ_AREA_SLOPE = 0.15


def eval_area(point: DesignPoint) -> dict:
    """Generalized Table 3 accounting: array logic + SRAM estimate."""
    n = point.array_n
    per_pe = PAPER_AREA["pes"] / (PAPER_N * PAPER_N)
    per_up = PAPER_AREA["upward"] / (PAPER_N * PAPER_N)
    per_split = PAPER_AREA["split"] / (PAPER_N * PAPER_N)
    per_cmp = PAPER_AREA["cmp"] / PAPER_N

    freq_scale = 1.0 + FREQ_AREA_SLOPE * (point.freq_ghz - 1.5)
    std = (per_pe * n * n + PAPER_AREA["other"]) * freq_scale
    split = per_split * n * n * (
        1.0 - SPLIT_LUT_FRACTION + SPLIT_LUT_FRACTION * point.pwl_segments / 8.0
    )
    upward = 0.0 if point.single_direction else per_up * n * n
    add = (split + upward + per_cmp * n) * freq_scale
    sram = (point.spad_kib + point.accum_kib) * SRAM_UM2_PER_KIB
    return {
        "std_um2": std,
        "fsa_additional_um2": add,
        "array_um2": std + add,
        "sram_um2": sram,
        "total_um2": std + add + sram,
        "overhead_pct": 100.0 * add / (std + add),
    }


# ---------------------------------------------------------------------------
# Full record
# ---------------------------------------------------------------------------

def evaluate(
    point: DesignPoint, *, accuracy_seq: int = 2048, seed: int = 0, device: str = "cuda"
) -> dict:
    """All objectives for one point, as a flat record (point fields included)."""
    point.validate()
    rec = {"label": point.label(), **dataclasses.asdict(point)}
    rec.update(eval_performance(point))
    rec.update(eval_area(point))
    rec.update(eval_accuracy(point, seq=accuracy_seq, seed=seed, device=device))
    return rec
