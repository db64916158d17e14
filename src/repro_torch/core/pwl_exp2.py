"""Piecewise-linear exp2 (paper §3.3), counterpart of ``repro.core.pwl_exp2``.

For ``x <= 0``::

    x = x_i + x_f,   x_i = ceil(x),   x_f = x - x_i in (-1, 0]
    2**x_f ~= slope_k * x_f + intercept_k   (K uniform chords on (-1, 0])
    exp2(x) = 2**x_i * 2**x_f               (an exponent-field update)

The tables are numpy and identical to the reference's.  In float32 the result
is bit-equal to ``repro.core.pwl_exp2.pwl_exp2`` as XLA computes it on the
CPU: the multiply and the add are rounded separately, and results below the
smallest normal float32 are flushed to zero, as the paper's hardware does
(§6.2.1) and as XLA's flush-to-zero does to the reference.  The CUDA kernels
share ``kernels/csrc/pwl_exp2.cuh``, which computes the same thing.

``pwl_error_stats`` (Fig. 12) takes the PWL it measures as an argument: this
module's ``pwl_exp2`` by default, the CUDA kernel where the autotuner runs it
on the card (``tune/objectives.py``).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

DEFAULT_SEGMENTS = 8
LOG2_E = float(np.log2(np.e))
_FLT_MIN = float(np.finfo(np.float32).tiny)  # 2**-126, the smallest normal

__all__ = [
    "DEFAULT_SEGMENTS",
    "LOG2_E",
    "segment_table",
    "packed_coeff_table",
    "pwl_exp2",
    "fp16_negative_normals",
    "pwl_error_stats",
]


@functools.lru_cache(maxsize=None)
def segment_table(num_segments: int = DEFAULT_SEGMENTS) -> tuple[np.ndarray, np.ndarray]:
    """Chord-interpolation (slope, intercept) tables for 2**x_f on (-1, 0].

    Segment k covers ``[-1 + k/K, -1 + (k+1)/K)``; the chord passes through
    the exact endpoints, so the approximation is continuous and exact at the
    K+1 breakpoints (in particular exp2(0) == 1 exactly).
    """
    k = np.arange(num_segments, dtype=np.float64)
    a = -1.0 + k / num_segments
    b = -1.0 + (k + 1.0) / num_segments
    fa, fb = np.exp2(a), np.exp2(b)
    slope = (fb - fa) * num_segments
    intercept = fa - slope * a
    return slope.astype(np.float32), intercept.astype(np.float32)


def packed_coeff_table(num_segments: int, lanes: int = 128) -> np.ndarray:
    """Slope/intercept packed as one [2, lanes] fp32 array (the reference's
    kernel operand layout; the CUDA kernel reads its first K columns)."""
    slope_t, intercept_t = segment_table(num_segments)
    packed = np.zeros((2, max(lanes, num_segments)), np.float32)
    packed[0, :num_segments] = slope_t
    packed[1, :num_segments] = intercept_t
    return packed


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**e for integer e in [-126, 127], built from its bits."""
    return ((e + 127) << 23).view(torch.float32)


def pwl_exp2(x: torch.Tensor, num_segments: int = DEFAULT_SEGMENTS) -> torch.Tensor:
    """FSA's piecewise-linear exp2 for non-positive inputs, in fp32.

    The result has the input's dtype.
    """
    slope_np, intercept_np = segment_table(num_segments)
    slope = torch.as_tensor(slope_np, device=x.device)
    intercept = torch.as_tensor(intercept_np, device=x.device)

    xf32 = x.to(torch.float32)
    x_i = torch.ceil(xf32)
    x_f = xf32 - x_i
    idx = torch.floor((x_f + 1.0) * num_segments).to(torch.int32)
    idx = idx.clamp(0, num_segments - 1).long()
    frac = slope[idx] * x_f + intercept[idx]  # one MAC per element

    # frac is about [0.5, 1], so every x_i < -126 gives a subnormal result,
    # which is flushed; clipping e at -126 keeps 2**e a normal number.  The
    # reference's own flush below x_i = -148 is contained in this one.
    e = x_i.clamp(-126.0, 127.0).to(torch.int32)
    out = frac * _pow2(e)
    out = torch.where((x_i < -126) | (out < _FLT_MIN), 0.0, out)
    return out.to(x.dtype)


def fp16_negative_normals() -> np.ndarray:
    """Every negative normal fp16 value (30,720 of them), as float32."""
    # sign=1, exponent in [1, 30], mantissa 0..1023.
    bits = np.arange(0, 1 << 15, dtype=np.uint16)
    vals = (bits | np.uint16(0x8000)).view(np.float16)
    mask = np.isfinite(vals) & (vals < 0) & (np.abs(vals) >= 2.0 ** -14)
    return vals[mask].astype(np.float32)


def pwl_error_stats(
    num_segments: int = DEFAULT_SEGMENTS,
    pwl: Callable[[torch.Tensor, int], torch.Tensor] = pwl_exp2,
) -> dict[str, float]:
    """Exhaustive error over all negative *normal* fp16 values (paper §6.2.1).

    Mean absolute and mean relative error of the PWL exp2 against fp64
    ground truth; reproduces Fig. 12 (8 segments: MAE ~1.4e-4, MRE
    2.728e-2).  The inputs are enumerated in numpy and ``pwl(x,
    num_segments)`` evaluates them, given a float32 CPU tensor and returning
    a tensor on any device; the fp16 flush and the fp64 statistics are the
    reference's, in numpy.  This module's ``pwl_exp2`` and the CUDA kernel
    give the bits of ``repro.core.pwl_exp2.pwl_exp2``, so the statistics
    equal the reference's to the last digit.
    """
    x = fp16_negative_normals()

    def _ftz16(v: np.ndarray) -> np.ndarray:
        """Round to fp16 and flush subnormal results to zero (§6.2.1)."""
        h = v.astype(np.float16)
        h[np.abs(h.astype(np.float64)) < 2.0 ** -14] = 0
        return h.astype(np.float64)

    # Accelerator output: fp16 with subnormal results flushed to zero.
    out = pwl(torch.from_numpy(x), num_segments)
    approx = _ftz16(out.cpu().numpy().astype(np.float64))
    # Ground truth: exact exp2 rounded to fp16 *keeping* subnormals.  The
    # mismatch in subnormal handling is why the MRE plateaus near 2.7e-2
    # while the MAE keeps shrinking with more segments (Fig. 12).
    exact = np.exp2(x.astype(np.float64)).astype(np.float16).astype(np.float64)
    abs_err = np.abs(approx - exact)
    # 0/0 (both sides an exact zero for x <= -25) counts as zero error; the
    # mean runs over all evaluated points, as the paper's MRE does.
    nz = exact > 0
    rel_err = np.zeros_like(abs_err)
    rel_err[nz] = abs_err[nz] / exact[nz]
    return {
        "num_segments": float(num_segments),
        "count": float(x.size),
        "mae": float(abs_err.mean()),
        "mre": float(rel_err.mean()),
        "max_abs": float(abs_err.max()),
    }
