"""Functional instruction-level simulator of the FSA device (paper §4).

Models the FSA microarchitecture at the fidelity needed to validate the
SystolicAttention schedule and its numerics:

  * three memory spaces with the paper's Table 1 capacities enforced —
    main memory (unbounded), scratchpad SRAM (192 KiB), accumulation SRAM
    (64 KiB);
  * the five compute instructions of §4.2 (LoadStationary, AttnScore,
    AttnValue, Reciprocal, AttnLseNorm) plus Load/Store DMA;
  * FSA numerics: fp16 operands, fp32 accumulation, rowmax via the CMP row,
    exp2 via the 8-segment PWL interpolation (Split unit + MAC);
  * deterministic cycle accounting per §3.5: the dual-FSM controller
    overlaps consecutive compute instructions so one inner FlashAttention
    iteration (LoadStationary + AttnScore + AttnValue) advances the
    timeline by exactly ``5N + 10`` cycles, and the outer-loop epilogue
    (Reciprocal + AttnLseNorm) by ``2N + 20``.

The simulator is intentionally *functional*: matrices move as whole tiles,
not element wavefronts, but every arithmetic result matches what the RTL
produces (same op order, same fp32 accumulate, same PWL tables), and every
latency matches the paper's closed-form cycle counts.

A numpy copy of ``repro.core.fsa_sim``, held equal to it by
``tests/test_torch_fsa.py``.  ``_pwl_exp2_np`` is the simulator's own
arithmetic on the host, not a pass on the card, so it stays numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .pwl_exp2 import LOG2_E, segment_table

__all__ = ["FSADevice", "FSAProgram", "Instr"]


def _pwl_exp2_np(x: np.ndarray, num_segments: int = 8) -> np.ndarray:
    """NumPy twin of core.pwl_exp2.pwl_exp2 (fp32, FTZ) for the simulator."""
    slope, intercept = segment_table(num_segments)
    x = x.astype(np.float32)
    x_i = np.ceil(x)
    x_f = x - x_i
    idx = np.clip(np.floor((x_f + 1.0) * num_segments).astype(np.int32), 0, num_segments - 1)
    frac = slope[idx] * x_f + intercept[idx]
    e = np.clip(x_i, -150, 127).astype(np.int32)
    out = np.ldexp(frac, e)
    out[x_i < -148] = 0.0
    return out.astype(np.float32)


@dataclasses.dataclass
class Instr:
    op: str
    operands: dict

    def __repr__(self) -> str:  # compact program listings
        return f"{self.op}({', '.join(f'{k}={v}' for k, v in self.operands.items())})"


@dataclasses.dataclass
class FSAProgram:
    instrs: list[Instr] = dataclasses.field(default_factory=list)

    def emit(self, op: str, **operands) -> None:
        self.instrs.append(Instr(op, operands))


class FSADevice:
    """Executes an FSAProgram; tracks memory capacity and cycle time."""

    def __init__(
        self,
        array_n: int = 128,
        spad_bytes: int = 192 * 1024,
        accum_bytes: int = 64 * 1024,
        num_segments: int = 8,
        freq_ghz: float = 1.5,
        single_direction: bool = False,
    ):
        self.n = array_n
        self.spad_bytes = spad_bytes
        self.accum_bytes = accum_bytes
        self.num_segments = num_segments
        self.freq_ghz = freq_ghz
        self.single_direction = single_direction
        self.reset()

    def reset(self) -> None:
        self.main: dict[str, np.ndarray] = {}
        self.spad: dict[str, np.ndarray] = {}
        self.accum: dict[str, np.ndarray] = {}
        self.stationary: Optional[np.ndarray] = None  # [d, Br] fp16
        self.old_m: Optional[np.ndarray] = None  # CMP-row registers, fp32
        self.cycles = 0
        self.compute_cycles = 0
        self.instr_count = 0

    # -- memory management ---------------------------------------------------

    def _check_capacity(self, space: dict, limit: int, name: str) -> None:
        used = sum(a.nbytes for a in space.values())
        if used > limit:
            raise MemoryError(
                f"{name} over capacity: {used} bytes used, limit {limit} "
                f"(tiles: { {k: v.shape for k, v in space.items()} })"
            )

    def alloc(self, space: str, key: str, shape: tuple, dtype) -> None:
        target = {"main": self.main, "spad": self.spad, "accum": self.accum}[space]
        target[key] = np.zeros(shape, dtype=dtype)
        if space == "spad":
            self._check_capacity(self.spad, self.spad_bytes, "scratchpad SRAM")
        elif space == "accum":
            self._check_capacity(self.accum, self.accum_bytes, "accumulation SRAM")

    # -- execution -----------------------------------------------------------

    def stagger_cycles(self, op: str) -> int:
        """Cycles the timeline advances when ``op`` issues behind its
        predecessor on the dual-FSM controller (§4.3)."""
        stagger = _COMPUTE_STAGGER[op](self.n)
        if self.single_direction and op == "attn_score":
            # §8.2 area-optimized variant: no upward-path registers, so S
            # drains through the bottom and the score pass cannot overlap
            # the preceding preload — one inner iteration becomes 6N + 10
            # instead of 5N + 10.
            stagger += self.n
        return stagger

    def run(self, program: FSAProgram) -> None:
        prev_compute = None
        for ins in program.instrs:
            self.instr_count += 1
            handler = getattr(self, f"_op_{ins.op}")
            handler(**ins.operands)
            if ins.op in _COMPUTE_STAGGER:
                # Dual-FSM controller (§4.3): the next compute instruction is
                # issued as soon as its data dependency inside the array is
                # met, so the timeline advances by the *stagger* of each
                # instruction, not its full latency.
                self.compute_cycles += self.stagger_cycles(ins.op)
                prev_compute = ins.op
        # Drain the last instruction's tail through the array.
        if prev_compute is not None:
            self.compute_cycles += _DRAIN_TAIL(self.n)
        self.cycles = self.compute_cycles

    # -- DMA -----------------------------------------------------------------

    def _op_load_tile(self, src: str, dst: str) -> None:
        self.spad[dst] = self.main[src].astype(np.float16)
        self._check_capacity(self.spad, self.spad_bytes, "scratchpad SRAM")

    def _op_store_tile(self, src: str, dst: str) -> None:
        self.main[dst] = self.accum[src].copy()

    # -- compute (§4.2) --------------------------------------------------------

    def _op_load_stationary(
        self, tile: str, transpose: bool = False, reset_stats: bool = True
    ) -> None:
        t = self.spad[tile].astype(np.float16)
        self.stationary = t.T if transpose else t  # [d, Br] layout
        if reset_stats:
            # Fresh Q tile -> reset the CMP-row running max.  Listing 2
            # reloads the same Q every inner iteration (the array held P/V
            # meanwhile); those reloads must NOT clear the running max.
            self.old_m = np.full((self.stationary.shape[1],), -np.inf, np.float32)

    def _op_attn_score(self, k: str, l: str, scale: float) -> None:
        """QK^T fused with online softmax: leaves P resident in the array.

        Implements lines 6-14 of Algorithm 1 with FSA semantics: rowmax via
        the CMP row as S streams out of the top, subtraction + constant
        multiply + PWL exp2 in place, rowsum on the way down.  ``l`` is the
        accumulation-SRAM tile holding (old_l) and receives new_l; the
        rescale factor b is forwarded down to the accumulator where it also
        rescales the O accumulator (handled in _op_attn_value via saved b).
        """
        assert self.stationary is not None, "load_stationary must precede attn_score"
        q = self.stationary.astype(np.float32)  # [d, Br]
        kt = self.spad[k].astype(np.float32)  # [Bc, d]
        # fp16 MACs with fp32 accumulation (Table 1), but S leaves the array
        # through the top as a 16-bit activation — quantize it.
        s = (kt @ q).astype(np.float16)  # [Bc, Br]: rows of S = cols of array
        c = np.float16(scale * LOG2_E)

        local_m = s.max(axis=0)  # CMP row: per-column (= per-Q-row) max
        new_m = np.maximum(local_m, self.old_m.astype(np.float16))
        a = np.maximum(
            (self.old_m.astype(np.float16) - new_m).astype(np.float32), -1e4
        )
        b = _pwl_exp2_np(np.float32(c) * a, self.num_segments)
        # N = S - new_m and the constant multiply happen on fp16 values
        # resident in the PEs; the PWL MAC accumulates in fp32, and P is
        # held back in the PE registers as fp16 (it feeds fp16 MACs in PV).
        n_mat = (s - new_m[None, :]).astype(np.float16)
        arg = (c * n_mat).astype(np.float32)
        p = _pwl_exp2_np(arg, self.num_segments).astype(np.float16)
        local_l = p.astype(np.float32).sum(axis=0)

        old_l = self.accum[l].reshape(-1)
        self.accum[l] = (old_l * b + local_l).reshape(self.accum[l].shape)
        self.old_m = new_m.astype(np.float32)
        self._p = p  # resident stationary (fp16) for AttnValue
        self._b = b

    def _op_attn_value(self, v: str, o: str) -> None:
        """O accumulation: local_O = P V along the downward path (line 15-16)."""
        vt = self.spad[v].astype(np.float32)  # [d, Bc] (V pre-transposed)
        p = self._p.astype(np.float32)  # [Bc, Br]
        local_o = vt @ p  # [d, Br]
        self.accum[o] = (self.accum[o] * self._b[None, :] + local_o).astype(np.float32)

    def _op_reciprocal(self, l: str) -> None:
        vals = self.accum[l]
        self._recip = np.where(vals == 0, 0.0, 1.0 / vals).astype(np.float32)

    def _op_attn_lse_norm(self, o: str) -> None:
        self.accum[o] = (self.accum[o] * self._recip.reshape(1, -1)).astype(np.float32)

    # -- reporting -------------------------------------------------------------

    def seconds(self) -> float:
        return self.cycles / (self.freq_ghz * 1e9)


# Stagger (cycles the timeline advances when this instruction issues behind
# its predecessor on the dual-FSM controller) chosen so that one inner
# iteration = 5N + 10 and the outer epilogue = 2N + 20, matching §3.5.
_COMPUTE_STAGGER = {
    "load_stationary": lambda n: n,          # preload, overlapped drain
    "attn_score": lambda n: 2 * n + 10,      # up-pass + CMP + in-place elementwise
    "attn_value": lambda n: 2 * n,           # down-pass PV
    "reciprocal": lambda n: 10,              # accumulator-local
    "attn_lse_norm": lambda n: 2 * n + 10,   # read-modify-write of O tile
}
_DRAIN_TAIL = lambda n: 0  # noqa: E731  (tail folded into staggers)
