"""Standalone PWL exp2: wrapper of the hand-written CUDA kernel
``kernels/csrc/pwl_exp2.cu``, the port of the Pallas TPU kernel
``repro.kernels.pwl_exp2.kernel._kernel``.

A tensor on the card launches the CUDA kernel on the current stream, or
raises on what the kernel does not take; a tensor on the CPU takes the plain
version, ``repro_torch.core.pwl_exp2.pwl_exp2``.

Departure from the Pallas kernel: the port rounds ``slope * x_f +
intercept`` twice, a multiply then an add, as ``repro.core.pwl_exp2.pwl_exp2``
does, and is bit-equal to that jnp function. The Pallas kernel in interpret
mode rounds it once, as a fused multiply-add. In float32 the two differ by at
most 1 ulp, on about one input in eight; in bfloat16 they are equal.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.pwl_exp2 import pwl_exp2 as pwl_exp2_plain
from repro_torch.core.pwl_exp2 import segment_table
from repro_torch.kernels import _build

MAX_SEGMENTS = 64  # kMaxSegments in csrc/pwl_exp2.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launches of the CUDA kernel in this process; callers reset and read it to
# show that a path went through the kernel.
launch_count = 0


def pwl_exp2_cuda(x: torch.Tensor, *, num_segments: int = 8) -> torch.Tensor:
    """PWL exp2 over a tensor of any shape (x <= 0), computed in fp32 and
    returned in x's dtype (float32, bfloat16 or float16)."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"pwl_exp2 takes float32, bfloat16 or float16, not {x.dtype}")
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"num_segments must be in [1, {MAX_SEGMENTS}]: {num_segments}")
    if x.device.type == "cpu":
        return pwl_exp2_plain(x, num_segments)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, num_segments)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``pwl_exp2.cu``'s library, built on first use, with its C signature."""
    lib = _build.load("pwl_exp2")
    p = ctypes.c_void_p
    lib.pwl_exp2.argtypes = [p, p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int, ctypes.c_int, p]
    lib.pwl_exp2.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _host_table(num_segments: int):
    """slope then intercept, 2 * K floats on the host (copied into each launch)."""
    slope, intercept = segment_table(num_segments)
    values = [*slope.tolist(), *intercept.tolist()]
    return (ctypes.c_float * len(values))(*values)


def _launch(x: torch.Tensor, num_segments: int) -> torch.Tensor:
    global launch_count
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.pwl_exp2(
            x.data_ptr(), out.data_ptr(), x.numel(), _host_table(num_segments),
            _DTYPE_CODES[x.dtype], num_segments,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pwl_exp2 kernel launch failed: cudaError_t {err}")
    launch_count += 1
    return out
