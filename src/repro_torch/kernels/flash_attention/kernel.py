"""Fused SystolicAttention forward: wrapper of the hand-written CUDA
kernels ``kernels/csrc/flash_fwd_sm90.cu`` and ``kernels/csrc/flash_fwd.cu``,
the ports of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel._fwd_kernel``.

``flash_attention_fwd`` keeps the reference's signature and ``[B, S, H, d]``
layout. A tensor on the card launches a CUDA kernel, or raises on what the
kernel does not take; a tensor on the CPU takes the plain version
(``flash_attention_fwd_plain``, the tiled Algorithm 1 of
``repro_torch.core.attention``). Pallas's ``interpret`` has no counterpart.

The table ``KERNELS`` chooses the kernel from ``(dtype, head_dim)``; each
``FwdKernel`` record holds what the choice implies:

* ``SM90`` (``flash_fwd_sm90.cu``) for bf16 at d 64 and 128: wgmma on the
  tensor cores, TMA loads, a producer warpgroup and two consumer
  warpgroups, 128 x 128 tiles. P is rounded to bf16 for the PV product (l
  and the LSE come from the fp32 P);
* ``SIMT`` (``flash_fwd.cu``) for fp32 at d 16 to 128 and bf16 at d 16
  and 32: register-blocked fp32 FMAs on the CUDA cores, two CTAs an SM,
  each loading K and V by cp.async while the other product runs; 64-key
  tiles and a q tile of 32 or 16 rows that the wrapper chooses per call
  (``simt_q_tile``: 16 where 32-row tiles would leave SMs idle); P kept in
  fp32 (the reference's numerics).

Nothing falls back: a CUDA tensor the chosen kernel cannot take raises.
The plain version mirrors the kernel that ``KERNELS`` gives its inputs: it
rounds P to bf16 where that kernel does (``fp32_p=True`` keeps the
reference's fp32 P). ``block_q`` and ``block_k`` set its tiles; the
kernels' k tiles are fixed (``fwd_tile``). Results of two tilings agree to
tolerance, not to the bit. With the PWL exp2 they agree less well: the
rescale factor ``pwl(c (m_old - m_new))`` is not multiplicative, so where
the k tiles break moves ``l`` and the LSE (by up to ~1e-3); on the card a
kernel is held against the plain version at its own k tile.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.attention import NEG_INF, _exp2_fn, algorithm1  # noqa: F401  (NEG_INF: the reference's name)
from repro_torch.core.pwl_exp2 import LOG2_E, packed_coeff_table
from repro_torch.kernels import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FwdKernel(NamedTuple):
    """One forward kernel: its name (the key of ``launch_counts``), its
    library and C entry point (all take the same arguments; ``flash_fwd``
    takes the q tile after them), its k tile (kBlockN of
    flash_fwd_sm90.cu, which is also its q tile; kBlockK of flash_fwd.cu,
    whose q tile ``simt_q_tile`` chooses), and the dtype it rounds P to for
    PV (None: fp32 P)."""

    name: str
    entry: str
    tile: int
    p_dtype: Optional[torch.dtype]


SM90 = FwdKernel("sm90", "flash_fwd_sm90", 128, torch.bfloat16)
SIMT = FwdKernel("simt", "flash_fwd", 64, None)

# (dtype, head_dim) -> the forward kernel that takes it on the card.
KERNELS = {
    **{(torch.float32, d): SIMT for d in HEAD_DIMS},
    (torch.bfloat16, 16): SIMT,
    (torch.bfloat16, 32): SIMT,
    (torch.bfloat16, 64): SM90,
    (torch.bfloat16, 128): SM90,
}

# Launches in this process by kernel; callers reset and read them to show
# that a path went through the kernels.  ``launch_count`` is their sum.
launch_counts = {SM90.name: 0, SIMT.name: 0}


def __getattr__(name: str):
    if name == "launch_count":
        return sum(launch_counts.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def kernel_for(dtype: torch.dtype, head_dim: int) -> FwdKernel:
    """The kernel that ``KERNELS`` gives ``(dtype, head_dim)``; raises
    ``ValueError`` where there is none."""
    try:
        return KERNELS[(dtype, head_dim)]
    except KeyError:
        raise ValueError(
            f"no forward kernel for {dtype} at head_dim {head_dim} "
            f"(fp32 or bf16, head_dim in {HEAD_DIMS})"
        ) from None


def fwd_tile(dtype: torch.dtype, head_dim: int) -> int:
    """The k tile of the kernel that takes ``(dtype, head_dim)``: the plain
    version's tiles when it is held against that kernel (its q tile only
    groups independent rows)."""
    return kernel_for(dtype, head_dim).tile


SIMT_Q_TILES = (32, 16)


def simt_q_tile(batch: int, heads: int, seq_q: int, sms: int) -> int:
    """The SIMT kernel's q tile: 32 rows, or 16 where 32-row tiles give
    fewer CTAs (one per (b*h, q tile)) than the card has SMs."""
    return 32 if batch * heads * -(-seq_q // 32) >= sms else 16


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
    if q.device.type in ("cpu", "meta"):  # meta: a shape-only trace (the dry-run)
        return flash_attention_fwd_plain(
            q, k, v, block_q=block_q, block_k=block_k, **kwargs
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, **kwargs)


def flash_attention_fwd_plain(
    q, k, v, *, causal, scale, q_offset, block_q, block_k, exp2_impl,
    num_segments, return_lse, fp32_p=False,
):
    """The plain PyTorch version of the kernel that ``KERNELS`` gives these
    inputs, on any device: P rounded to bf16 for PV where that kernel
    rounds it, unless ``fp32_p``."""
    kernel = KERNELS.get((q.dtype, q.shape[-1]))
    p_dtype = None if fp32_p or kernel is None else kernel.p_dtype
    o, m, l = algorithm1(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k,
        exp2=_exp2_fn(exp2_impl, num_segments), scale=scale, q_offset=q_offset,
        p_dtype=p_dtype,
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
def _library(name: str) -> ctypes.CDLL:
    """The library of a kernel's entry point, built on first use, with its
    C signature."""
    lib = _build.load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = getattr(lib, name)
    fn.argtypes = [p] * 6 + [i] * 7 + [ll] * 3 + [i, i, ctypes.c_float, i, i, p]
    if name == SIMT.entry:
        fn.argtypes.append(i)  # the q tile
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def check_tma_layout(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless a TMA tensor map (the sm90 kernel) and
    16-byte ``cp.async`` copies (the SIMT kernel) can describe ``t``
    (``[B, S, H, d]``): dense ``[S, H, d]`` inner dims, a 16-byte aligned
    base, and byte strides that are multiples of 16 (the batch stride only
    where B > 1). A prefix of a KV cache, batch stride capacity * H * d,
    passes. Reads only shapes, strides and the address, so it runs on CPU
    tensors too."""
    _check_layout(name, t)
    base = t.data_ptr()
    if base % 16:
        raise ValueError(f"{name}: base address {base:#x} is not 16-byte aligned (TMA, cp.async)")
    batch, _, heads, d = t.shape
    size = t.element_size()
    strides = {"head": d * size, "sequence": heads * d * size}
    if batch > 1:
        strides["batch"] = t.stride(0) * size
    for dim, nbytes in strides.items():
        if nbytes % 16:
            raise ValueError(
                f"{name}: {dim} stride of {nbytes} bytes is not a multiple of 16 (TMA, cp.async)")


def _launch(q, k, v, *, causal, scale, q_offset, exp2_impl, num_segments, return_lse,
            block_q=None):
    """Launch the kernel that ``KERNELS`` gives the inputs; ``block_q``
    overrides ``simt_q_tile`` for the SIMT kernel (to time both tiles)."""
    batch, sq, heads, d = q.shape
    _, sk, kv_heads, _ = k.shape
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of different dtypes: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[-1] != d or v.shape != k.shape or k.shape[0] != batch:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    kernel = kernel_for(q.dtype, d)
    if sq < 1 or sk < 1 or q_offset < 0:
        raise ValueError(f"need Sq >= 1, Sk >= 1, q_offset >= 0: {sq}, {sk}, {q_offset}")
    if exp2_impl == "pwl" and not 1 <= num_segments <= 128:
        raise ValueError(f"num_segments must be in [1, 128]: {num_segments}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tma_layout(name, t)
    extra = ()
    if kernel is SIMT:
        if block_q is None:
            block_q = simt_q_tile(batch, heads, sq, _sm_count(q.device))
        if block_q not in SIMT_Q_TILES:
            raise ValueError(f"SIMT q tile must be one of {SIMT_Q_TILES}: {block_q}")
        extra = (block_q,)

    entry = getattr(_library(kernel.entry), kernel.entry)
    o = torch.empty((batch, sq, heads, d), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((batch * heads, sq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    pwl = exp2_impl == "pwl"
    table = _coeff_table(num_segments, q.device) if pwl else None
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            table.data_ptr() if table is not None else None,
            _DTYPE_CODES[q.dtype], batch, heads, kv_heads, sq, sk, d,
            q.stride(0), k.stride(0), v.stride(0),
            q_offset, int(causal), scale * LOG2_E, int(pwl), num_segments,
            torch.cuda.current_stream(q.device).cuda_stream, *extra,
        )
    if err != 0:
        # flash_fwd_sm90.cu: 900, libcuda has no cuTensorMapEncodeTiled;
        # 1000 + CUresult, libcuda refused a tensor map. flash_fwd.cu: 716,
        # a base or batch stride off 16 bytes.
        raise RuntimeError(f"{kernel.entry} kernel launch failed: error {err}")
    launch_counts[kernel.name] += 1
    return (o, lse) if return_lse else o
