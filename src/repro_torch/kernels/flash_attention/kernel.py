"""Fused SystolicAttention forward: wrapper of the hand-written CUDA kernel
``kernels/csrc/flash_fwd.cu``, the port of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel._fwd_kernel``.

``flash_attention_fwd`` keeps the reference's signature and ``[B, S, H, d]``
layout. A tensor on the card launches the CUDA kernel, or raises on what the
kernel does not take; a tensor on the CPU takes the plain version
(``flash_attention_fwd_plain``, the tiled Algorithm 1 of
``repro_torch.core.attention``). Pallas's ``interpret`` has no counterpart.

The CUDA kernel's tiles are fixed at ``KERNEL_BLOCK`` x ``KERNEL_BLOCK``;
``block_q`` and ``block_k`` set the plain version's tiles. Results of two
tilings agree to tolerance, not to the bit. With the PWL exp2 they agree
less well: the rescale factor ``pwl(c (m_old - m_new))`` is not
multiplicative, so where the k tiles break moves ``l`` and the LSE (by up
to ~1e-3); the kernel is held against the plain version at its own tiling.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.attention import _exp2_fn, algorithm1
from repro_torch.core.pwl_exp2 import LOG2_E, packed_coeff_table
from repro_torch.kernels import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
KERNEL_BLOCK = 64  # kBlockQ = kBlockK in csrc/flash_fwd.cu
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel in this process; callers reset and read it to
# show that a path went through the kernel.
launch_count = 0


def flash_attention_fwd(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, d]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    exp2_impl: str = "exact",
    num_segments: int = 8,
    return_lse: bool = False,
):
    """Attention output ``[B, Sq, H, d]`` in q's dtype, and with
    ``return_lse`` the base-2 LSE ``c * m + log2 l`` as ``[B * H, Sq]`` fp32
    (the reference pads its LSE rows to whole blocks; the pad carries no
    meaning and is left out here)."""
    if not q.shape[2] % k.shape[2] == 0:
        raise ValueError(f"heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if exp2_impl not in ("exact", "pwl"):
        raise ValueError(f"unknown exp2 impl: {exp2_impl!r} (want 'exact' or 'pwl')")
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    kwargs = dict(
        causal=causal, scale=scale, q_offset=q_offset,
        exp2_impl=exp2_impl, num_segments=num_segments, return_lse=return_lse,
    )
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, block_q=block_q, block_k=block_k, **kwargs
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, **kwargs)


def flash_attention_fwd_plain(
    q, k, v, *, causal, scale, q_offset, block_q, block_k, exp2_impl,
    num_segments, return_lse,
):
    """The plain PyTorch version of the kernel, on any device."""
    o, m, l = algorithm1(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k,
        exp2=_exp2_fn(exp2_impl, num_segments), scale=scale, q_offset=q_offset,
    )
    out = o.permute(0, 2, 1, 3).to(q.dtype)
    if not return_lse:
        return out
    lse = scale * LOG2_E * m + torch.log2(l)
    return out, lse.reshape(-1, q.shape[1])


@functools.lru_cache(maxsize=None)
def _coeff_table(num_segments: int, device: torch.device) -> torch.Tensor:
    """[2, K] fp32 slope/intercept rows on ``device``."""
    table = np.ascontiguousarray(packed_coeff_table(num_segments)[:, :num_segments])
    return torch.as_tensor(table, device=device)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``flash_fwd.cu``'s library, built on first use, with its C signature."""
    lib = _build.load("flash_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd.argtypes = [p] * 6 + [i] * 7 + [ll] * 3 + [i, i, ctypes.c_float, i, i, p]
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def is_dense(t: torch.Tensor) -> bool:
    """Whether a ``[B, S, H, d]`` tensor has dense ``[S, H, d]`` inner dims
    (any batch stride), the layout the kernels take."""
    _, seq, heads, d = t.shape
    return (
        t.stride(3) == 1
        and (heads == 1 or t.stride(2) == d)
        and (seq == 1 or t.stride(1) == heads * d)
    )


def _check_layout(name: str, t: torch.Tensor) -> None:
    if not is_dense(t):
        raise ValueError(
            f"{name} needs dense [S, H, d] inner dims (any batch stride); "
            f"got strides {t.stride()} for shape {tuple(t.shape)}"
        )


def _launch(q, k, v, *, causal, scale, q_offset, exp2_impl, num_segments, return_lse):
    global launch_count
    batch, sq, heads, d = q.shape
    _, sk, kv_heads, _ = k.shape
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"kernel takes fp32 or bf16 q/k/v of one dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape or k.shape[0] != batch:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sq < 1 or sk < 1 or q_offset < 0:
        raise ValueError(f"need Sq >= 1, Sk >= 1, q_offset >= 0: {sq}, {sk}, {q_offset}")
    if exp2_impl == "pwl" and not 1 <= num_segments <= 128:
        raise ValueError(f"num_segments must be in [1, 128]: {num_segments}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)

    lib = _library()
    o = torch.empty((batch, sq, heads, d), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch * heads, sq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    pwl = exp2_impl == "pwl"
    table = _coeff_table(num_segments, q.device) if pwl else None
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            table.data_ptr() if table is not None else None,
            _DTYPE_CODES[q.dtype], batch, heads, kv_heads, sq, sk, d,
            q.stride(0), k.stride(0), v.stride(0),
            q_offset, int(causal), scale * LOG2_E, int(pwl), num_segments,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {err}")
    launch_count += 1
    return (o, lse) if return_lse else o
