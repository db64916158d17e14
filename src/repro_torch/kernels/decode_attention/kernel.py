"""Decode attention over a KV cache: wrapper of the hand-written CUDA kernel
``kernels/csrc/decode_attention.cu``.

It replaces no TPU kernel: the reference's decode and speculative verify
attend with a ``jnp.einsum`` pair that XLA compiles
(``repro.models.attention.verify_attention``), and the plain version here,
``decode_attention_plain``, is that formulation: every row of the cache
widened to fp32 and scored, rows past ``write_pos + j`` masked with -1e30.
The kernel reads the cache once in its own dtype, widens it in registers,
accumulates in fp32 and never reads a masked row (see the source).

``decode_attention_fwd`` takes the plain version for tensors on the CPU (or
``meta``, a shape-only trace) and launches the kernel for tensors on the
card, or raises on what the kernel does not take. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # kMaxHeadDim in csrc/decode_attention.cu
Q_ROWS_PER_CTA = 16  # query rows a CTA takes: 4 warps of 4 (the launcher's q_chunks)
# The split along the rows (``split_plan``): at least this many CTAs a
# streaming multiprocessor where splits of MIN_ROWS rows allow it, and rows
# a split between these bounds.
CTAS_PER_SM = 4
MIN_ROWS, MAX_ROWS = 64, 512

# Calls that launched the kernel (and its combine) in this process; callers
# reset and read it to show that a path went through the kernel.
launches = 0


def decode_attention_fwd(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, max_len, Hkv, d]
    v: torch.Tensor,  # [B, max_len, Hkv, d]
    write_pos: torch.Tensor,  # [B] int: the row of query 0 per slot
    scale: float,
) -> torch.Tensor:
    """Query row j of slot b against the cached rows ``0 ..
    min(write_pos[b] + j, max_len - 1)``, GQA head h on KV head ``h // (H
    // Hkv)``: the fp32 output ``[B, S, H, d]``."""
    tensors = (q, k, v, write_pos)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"q, k, v, write_pos on different devices: {[str(t.device) for t in tensors]}")
    if q.device.type in ("cpu", "meta"):
        return decode_attention_plain(q, k, v, write_pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, write_pos, scale)


def decode_attention_plain(q, k, v, write_pos, scale) -> torch.Tensor:
    """The plain version on any device: the reference's masked grouped
    einsums over the cache widened to fp32. Any K/V dtype."""
    b, s_new, heads, hd = q.shape
    max_len, kv_heads = k.shape[1], k.shape[2]
    rows = write_pos.to(torch.long)[:, None] + torch.arange(s_new, device=q.device)[None, :]  # [B, S]
    # GQA via a grouped product over [B, S, Hkv, rep, d]: K/V are never
    # repeated rep times.  Query j sees the keys up to its own row.
    qg = q.reshape(b, s_new, kv_heads, heads // kv_heads, hd).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    valid = (
        torch.arange(max_len, device=q.device)[None, None, None, None, :]
        <= rows[:, None, None, :, None]
    )
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhrqk,bkhd->bqhrd", p, v.float()).reshape(b, s_new, heads, hd)


def check_inputs(q, k, v, write_pos) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors: q, k, v
    of one dtype, fp32 or bf16; ``[B, S, H, d]`` against ``[B, max_len,
    Hkv, d]`` with Hkv dividing H; d a multiple of 8 up to 256, dense, and
    every other stride and each base on 16 bytes; ``write_pos`` ``[B]`` of
    integers. Reads only dtypes, shapes, strides and addresses, so it runs
    on CPU tensors too."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must share one dtype of {tuple(_DTYPE_CODES)}: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B, S, H, d], k and v [B, max_len, Hkv, d]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s_new, heads, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or heads % k.shape[2] or min(q.shape + k.shape) < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit the cache {tuple(k.shape)}")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is not a multiple of 8 up to {MAX_HEAD_DIM}")
    if write_pos.shape != (b,) or write_pos.dtype.is_floating_point:
        raise ValueError(f"write_pos must be [B] integers: {tuple(write_pos.shape)} {write_pos.dtype}")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be dense along d: strides {t.stride()}")
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}: base or strides {t.stride()} off 16 bytes (16-byte loads)")


def split_plan(ctas: int, max_len: int, sms: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of a cache of ``max_len`` rows for a grid
    of ``ctas`` CTAs before the split (one a slot, KV head and
    ``Q_ROWS_PER_CTA`` of its query rows): enough splits to give
    ``CTAS_PER_SM`` CTAs an SM, with at least ``MIN_ROWS`` (or all
    ``max_len``) and at most ``MAX_ROWS`` rows a split, and ``splits *
    rows_per_split >= max_len``."""
    most = max(1, max_len // MIN_ROWS)
    splits = min(most, max(-(-max_len // MAX_ROWS), -(-CTAS_PER_SM * sms // ctas)))
    rows = -(-max_len // splits)
    return -(-max_len // rows), rows


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``decode_attention.cu``'s library, built on first use, with its C
    signature."""
    lib = _build.load("decode_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention.argtypes = [p] * 8 + [i] * 7 + [ll] * 9 + [i, i, ctypes.c_float, p]
    lib.decode_attention.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, k, v, write_pos, scale) -> torch.Tensor:
    global launches
    check_inputs(q, k, v, write_pos)
    b, s_new, heads, hd = q.shape
    max_len, kv_heads = k.shape[1], k.shape[2]
    ctas = b * kv_heads * -(-s_new * (heads // kv_heads) // Q_ROWS_PER_CTA)
    splits, rows = split_plan(ctas, max_len, _sm_count(q.device))
    write_pos = write_pos.to(torch.int32).contiguous()
    out = torch.empty((b, s_new, heads, hd), dtype=torch.float32, device=q.device)
    parts = b * heads * s_new * splits  # (slot, KV head, query row, split)
    o_part = torch.empty((parts, hd), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((2, parts), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), write_pos.data_ptr(),
            out.data_ptr(), o_part.data_ptr(), ml_part[0].data_ptr(), ml_part[1].data_ptr(),
            _DTYPE_CODES[q.dtype], b, s_new, heads, kv_heads, max_len, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            splits, rows, scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
