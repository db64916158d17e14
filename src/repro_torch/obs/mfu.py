"""Model-FLOPs-utilization (MFU) accounting against the paper's FSA array
(a copy of ``repro.obs.mfu`` on the port's configs and ``systolic_model``).

The paper's headline metric (Fig. 11) is attention FLOPs/s utilization:
achieved FLOPs divided by the array's peak.  This module makes the repo
report that metric about its *own* execution:

  * closed-form model FLOPs per phase — PaLM-appendix accounting
    (2 FLOPs per active parameter per token forward, 3x for the backward
    pass) plus the causal attention term ``4 * ctx * head_dim * heads``
    per token per layer, specialized for train / prefill / decode /
    speculative-verify calls;
  * the **paper-ideal** reference reuses ``core.systolic_model`` verbatim:
    ``fsa_utilization(seq)`` times the array's peak is what FSA achieves
    on that attention shape per Fig. 11, so ``mfu / ideal`` says how far
    this host run sits from the paper's own ceiling;
  * ``MFUMeter`` folds both into a ``repro_torch.obs`` registry as per-phase
    gauges (``model_flops_per_s``, ``mfu``, ``paper_ideal_utilization``,
    ``mfu_vs_paper_ideal``) and a cumulative FLOPs counter.

The denominator is the paper's FSA array (``PAPER_ARRAY``: N = 128 at
1.5 GHz, 49.15 TFLOP/s), not the card the port runs on: on an H100 the
gauge reads the card's achieved FLOPs/s in units of that array's peak, and
can exceed 1.  The port adds no H100 denominator (the reference has none).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import systolic_model

__all__ = [
    "ArrayConfig",
    "PAPER_ARRAY",
    "train_step_flops",
    "prefill_flops",
    "decode_flops",
    "verify_flops",
    "paper_ideal_flops_per_s",
    "MFUMeter",
]


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """The systolic array the MFU denominator refers to (paper Table 1:
    N = 128 at 1.5 GHz; ``tune.DesignPoint`` uses the same defaults)."""

    array_n: int = 128
    freq_ghz: float = 1.5
    single_direction: bool = False

    @property
    def peak_flops_per_s(self) -> float:
        """2 * N^2 MACs-as-FLOPs per cycle at the synthesis clock."""
        return 2.0 * self.array_n * self.array_n * self.freq_ghz * 1e9


PAPER_ARRAY = ArrayConfig()


# ---------------------------------------------------------------------------
# Model-FLOPs closed forms
# ---------------------------------------------------------------------------


def _attn_flops_per_token(cfg: ModelConfig, context: float) -> float:
    """Score + value matmul FLOPs for one query token attending over
    ``context`` keys: 2 * (QK^T) + 2 * (PV) per head per layer."""
    return 4.0 * context * cfg.resolved_head_dim * cfg.num_heads * cfg.num_layers


def train_step_flops(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    """One optimizer step over ``batch`` sequences of ``seq_len`` tokens:
    6 FLOPs per active param per token (fwd 2 + bwd 4), plus the causal
    attention term (mean context seq/2) at 3x forward cost."""
    tokens = float(batch) * seq_len
    param = 6.0 * cfg.active_param_count() * tokens
    attn = 3.0 * _attn_flops_per_token(cfg, seq_len / 2.0) * tokens
    return param + attn


def prefill_flops(cfg: ModelConfig, prompt_len: int) -> float:
    """Forward over one prompt (causal: token i attends to i+1 keys)."""
    param = 2.0 * cfg.active_param_count() * prompt_len
    attn = _attn_flops_per_token(cfg, (prompt_len + 1) / 2.0) * prompt_len
    return param + attn


def decode_flops(cfg: ModelConfig, contexts) -> float:
    """One batched decode step; ``contexts`` = per-live-slot KV lengths."""
    contexts = np.asarray(contexts, dtype=np.float64)
    n = float(contexts.size)
    param = 2.0 * cfg.active_param_count() * n
    attn = sum(_attn_flops_per_token(cfg, c + 1.0) for c in contexts)
    return param + attn


def verify_flops(cfg: ModelConfig, contexts, k: int) -> float:
    """One speculative verify: K+1 teacher-forced tokens per slot, each
    attending over its (growing) context."""
    total = 0.0
    for c in np.asarray(contexts, dtype=np.float64):
        for j in range(k + 1):
            total += _attn_flops_per_token(cfg, c + j + 1.0)
    param = 2.0 * cfg.active_param_count() * float(len(contexts)) * (k + 1)
    return param + total


def paper_ideal_flops_per_s(
    seq_len: int,
    head_dim: int = 128,
    array: ArrayConfig = PAPER_ARRAY,
) -> float:
    """FLOPs/s FSA achieves on this attention shape per Fig. 11: the
    ``systolic_model`` closed-form utilization times the array peak."""
    util = systolic_model.fsa_utilization(
        seq_len, head_dim, array.array_n,
        single_direction=array.single_direction,
    )
    return util * array.peak_flops_per_s


class MFUMeter:
    """Per-phase MFU gauges on a ``repro_torch.obs`` registry.

    ``record(phase, flops, seconds, seq_len=...)`` computes achieved
    FLOPs/s, divides by the array peak (-> MFU, the Fig. 11 y-axis), and —
    when the phase has a characteristic attention length — also reports
    the paper-ideal utilization at that length and the achieved/ideal
    ratio.  Returns the computed record as a plain dict."""

    def __init__(self, cfg: ModelConfig, registry, *,
                 array: ArrayConfig = PAPER_ARRAY, prefix: str = ""):
        self.cfg, self.array = cfg, array
        p = prefix
        self.registry = registry
        self._flops_total = registry.counter(
            p + "model_flops_total", "cumulative model FLOPs", ("phase",)
        )
        self._flops_per_s = registry.gauge(
            p + "model_flops_per_s", "achieved model FLOPs/s (last call)",
            ("phase",),
        )
        self._mfu = registry.gauge(
            p + "mfu",
            "model FLOPs utilization vs the FSA array peak "
            f"({array.peak_flops_per_s / 1e12:.3f} TFLOP/s)",
            ("phase",),
        )
        self._ideal = registry.gauge(
            p + "paper_ideal_utilization",
            "Fig. 11 FSA utilization at this phase's attention length",
            ("phase",),
        )
        self._vs_ideal = registry.gauge(
            p + "mfu_vs_paper_ideal",
            "achieved utilization / paper-ideal FSA utilization",
            ("phase",),
        )

    def record(self, phase: str, flops: float, seconds: float, *,
               seq_len: Optional[int] = None) -> dict:
        seconds = max(float(seconds), 1e-12)
        fps = flops / seconds
        mfu = fps / self.array.peak_flops_per_s
        self._flops_total.labels(phase=phase).inc(flops)
        self._flops_per_s.labels(phase=phase).set(fps)
        self._mfu.labels(phase=phase).set(mfu)
        rec = {"phase": phase, "flops": flops, "flops_per_s": fps, "mfu": mfu}
        if seq_len is not None and seq_len >= 1:
            ideal = systolic_model.fsa_utilization(
                int(seq_len), self.cfg.resolved_head_dim, self.array.array_n,
                single_direction=self.array.single_direction,
            ) if self.cfg.resolved_head_dim == self.array.array_n else (
                # The closed form maps Bc = N_ROWS = d; for other head dims
                # report utilization at the paper's head_dim instead.
                systolic_model.fsa_utilization(
                    int(seq_len), self.array.array_n, self.array.array_n,
                    single_direction=self.array.single_direction,
                )
            )
            self._ideal.labels(phase=phase).set(ideal)
            self._vs_ideal.labels(phase=phase).set(mfu / ideal)
            rec.update(paper_ideal_utilization=ideal, mfu_vs_paper_ideal=mfu / ideal)
        return rec

    # -- phase-specific conveniences ---------------------------------------

    def train_step(self, batch: int, seq_len: int, seconds: float) -> dict:
        return self.record(
            "train", train_step_flops(self.cfg, batch, seq_len), seconds,
            seq_len=seq_len,
        )

    def prefill(self, prompt_len: int, seconds: float) -> dict:
        return self.record(
            "prefill", prefill_flops(self.cfg, prompt_len), seconds,
            seq_len=prompt_len,
        )

    def decode(self, contexts, seconds: float) -> dict:
        ctx = np.asarray(contexts)
        seq = int(ctx.mean()) + 1 if ctx.size else None
        return self.record(
            "decode", decode_flops(self.cfg, contexts), seconds, seq_len=seq
        )

    def verify(self, contexts, k: int, seconds: float) -> dict:
        ctx = np.asarray(contexts)
        seq = int(ctx.mean()) + k + 1 if ctx.size else None
        return self.record(
            "verify", verify_flops(self.cfg, contexts, k), seconds, seq_len=seq
        )
