"""The FSA design space: one frozen, hashable point per candidate device.

The paper evaluates a single design point — a 128 x 128 array with the
dual-direction SystolicAttention schedule, an 8-segment PWL exp2, a
192 KiB scratchpad and a 64 KiB accumulation SRAM at 1.5 GHz (Table 1).
``DesignPoint`` names every free axis of that design so the autotuner can
sweep them:

  * ``array_n``       — systolic array dimension N (head_dim maps to N,
                        paper §3.5: Bc = N_ROWS = d);
  * ``schedule``      — "standard" (dual-direction, 5N+10 cycles/tile) or
                        "single_direction" (area-optimized §8.2 variant,
                        6N+10 cycles/tile, no upward-path registers);
  * ``pwl_segments``  — exp2 interpolation segments (paper §3.3, Fig. 12);
  * ``spad_kib``      — scratchpad SRAM capacity;
  * ``accum_kib``     — accumulation SRAM capacity;
  * ``freq_ghz``      — synthesis clock target.

Validity follows the Table 1 capacity model: the scratchpad must hold the
double-buffered Q/K/V^T fp16 working set of Listing 2 (six N x N tiles =
``12 N^2`` bytes) and the accumulation SRAM the fp32 O tile (``4 N^2``
bytes; the l vector lives in the accumulator's per-column registers).
The paper's 192 KiB / 64 KiB are the *exact* fit at N = 128 — the paper
point is minimal-SRAM by construction.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "DesignPoint",
    "SCHEDULES",
    "paper_point",
    "spad_required_bytes",
    "accum_required_bytes",
    "exact_fit_point",
]

SCHEDULES = ("standard", "single_direction")


def spad_required_bytes(array_n: int) -> int:
    """Double-buffered Q/K/V^T fp16 tiles (Listing 2): 6 tiles of 2N^2 B."""
    return 12 * array_n * array_n


def accum_required_bytes(array_n: int) -> int:
    """One fp32 O tile ([d, Br] = N x N); l is held in accumulator registers."""
    return 4 * array_n * array_n


def _is_pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One hashable FSA configuration; the default is the paper's design."""

    array_n: int = 128
    schedule: str = "standard"
    pwl_segments: int = 8
    spad_kib: int = 192
    accum_kib: int = 64
    freq_ghz: float = 1.5

    # -- derived ------------------------------------------------------------

    @property
    def single_direction(self) -> bool:
        return self.schedule == "single_direction"

    @property
    def spad_bytes(self) -> int:
        return self.spad_kib * 1024

    @property
    def accum_bytes(self) -> int:
        return self.accum_kib * 1024

    @property
    def peak_flops_per_cycle(self) -> float:
        return 2.0 * self.array_n * self.array_n

    def label(self) -> str:
        sched = "1dir" if self.single_direction else "2dir"
        return (
            f"N{self.array_n}/{sched}/K{self.pwl_segments}"
            f"/S{self.spad_kib}+{self.accum_kib}KiB/{self.freq_ghz:g}GHz"
        )

    # -- validity (Table 1 capacity model) ----------------------------------

    def validate(self) -> None:
        """Raise ValueError when the point is not a buildable FSA device."""
        if not _is_pow2(self.array_n) or self.array_n < 8:
            raise ValueError(
                f"array_n must be a power of two >= 8 (lane alignment), got "
                f"{self.array_n}"
            )
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {self.schedule!r}")
        if not _is_pow2(self.pwl_segments) or not 2 <= self.pwl_segments <= 64:
            raise ValueError(
                "pwl_segments must be a power of two in [2, 64] (the segment "
                f"index is encoded in intercept exponent MSBs, §3.3), got "
                f"{self.pwl_segments}"
            )
        need_spad = spad_required_bytes(self.array_n)
        if self.spad_bytes < need_spad:
            raise ValueError(
                f"scratchpad {self.spad_kib} KiB cannot hold the double-"
                f"buffered Q/K/V^T working set of an N={self.array_n} array "
                f"({need_spad} bytes, Table 1)"
            )
        need_accum = accum_required_bytes(self.array_n)
        if self.accum_bytes < need_accum:
            raise ValueError(
                f"accumulation SRAM {self.accum_kib} KiB cannot hold the fp32 "
                f"O tile of an N={self.array_n} array ({need_accum} bytes, "
                f"Table 1)"
            )
        if not 0.25 <= self.freq_ghz <= 4.0:
            raise ValueError(f"freq_ghz outside the modelled range: {self.freq_ghz}")

    def is_valid(self) -> bool:
        try:
            self.validate()
        except ValueError:
            return False
        return True


def paper_point() -> DesignPoint:
    """The paper's published design (Table 1): all defaults."""
    return DesignPoint()


def exact_fit_point(
    array_n: int,
    *,
    schedule: str = "standard",
    pwl_segments: int = 8,
    freq_ghz: float = 1.5,
    sram_over: int = 1,
) -> DesignPoint:
    """A point with minimal (or ``sram_over``x) SRAM for its array size."""
    spad = spad_required_bytes(array_n) * sram_over
    accum = accum_required_bytes(array_n) * sram_over
    return DesignPoint(
        array_n=array_n,
        schedule=schedule,
        pwl_segments=pwl_segments,
        spad_kib=-(-spad // 1024),
        accum_kib=-(-accum // 1024),
        freq_ghz=freq_ghz,
    )
