"""FlashAttention-2 backward: wrapper of the hand-written CUDA kernels in
``kernels/csrc/flash_bwd.cu``, the port of the Pallas TPU kernels
``repro.kernels.flash_attention.kernel_bwd._dq_kernel`` and ``_dkv_kernel``.

``flash_attention_bwd`` keeps the reference's signature and ``[B, S, H, d]``
layout and takes the unpadded ``[B * H, Sq]`` base-2 LSE of
``flash_attention_fwd``. P = exp2(c S - LSE) is recomputed per tile, never
stored, always with the exact exp2 (also after a PWL forward, as the
reference's backward does). A tensor on the card launches two kernels:

  * ``flash_bwd_dq`` — one CTA per (b*h, q tile): delta = rowsum(dO * O)
    for its rows (written for the second kernel), then dQ over the k tiles;
  * ``flash_bwd_dkv`` — one CTA per (b, kv head, k tile): dK and dV over
    the ``rep`` q heads of its group and their q tiles.

Neither needs atomics, so the result is deterministic. A tensor on the CPU
takes the plain version (``flash_attention_bwd_plain``).

GQA (departure from the reference, ROADMAP queue 3): the reference rounds
each q head's dK/dV partial to k's dtype and then sums the group; here the
group is summed in fp32 and rounded once. In fp32 the two agree to the
order of the sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.attention import NEG_INF, _pad_seq
from repro_torch.core.pwl_exp2 import LOG2_E
from repro_torch.kernels import _build
from .kernel import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, HEAD_DIMS, _DTYPE_CODES, _check_layout, is_dense

KERNEL_BLOCK = 64  # kBlock of csrc/flash_bwd.cu: its q and k tiles

# Launches of each CUDA kernel in this process; callers reset and read them
# to show that a path went through the kernels.
dq_launch_count = 0
dkv_launch_count = 0


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, d]
    out: torch.Tensor,  # [B, Sq, H, d] forward output
    lse: torch.Tensor,  # [B * H, Sq] fp32 base-2 LSE from the forward
    do: torch.Tensor,  # [B, Sq, H, d]
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
):
    """``(dq, dk, dv)`` in the dtypes of ``q``, ``k`` and ``v``.

    ``block_q`` and ``block_k`` set the plain version's tiles; the kernels'
    are fixed (64 x 64)."""
    if not q.shape[2] % k.shape[2] == 0:
        raise ValueError(f"heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    tensors = (q, k, v, out, lse, do)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(*tensors, block_q=block_q, block_k=block_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(*tensors, **kw)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal, scale, q_offset, block_q, block_k):
    """The plain PyTorch version of the kernels, on any device: FA-2 in fp32
    over ``block_q`` x ``block_k`` tiles, the q heads of a GQA group folded
    into the rows of one product (so dK and dV sum the group in fp32).
    Causal tiles wholly above the diagonal are skipped: P is 0 there."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    c = scale * LOG2_E
    bq, bk = min(block_q, sq), min(block_k, sk)
    n_q, n_k = -(-sq // bq), -(-sk // bk)
    pad_q, pad_k = n_q * bq - sq, n_k * bk - sk
    dev = q.device

    def rows_of(x):  # [B, Sq, H, d] -> [B, Hkv, rep, Sq', d] fp32
        return _pad_seq(x.float().permute(0, 2, 1, 3), pad_q).reshape(b, hkv, rep, -1, d)

    q32, do32 = rows_of(q), rows_of(do)
    delta = (do32 * rows_of(out)).sum(-1)  # [B, Hkv, rep, Sq']: FA-2's preprocess
    lse32 = F.pad(lse.float().reshape(b, hkv, rep, sq), (0, pad_q))
    k32 = _pad_seq(k.float().permute(0, 2, 1, 3), pad_k)  # [B, Hkv, Sk', d]
    v32 = _pad_seq(v.float().permute(0, 2, 1, 3), pad_k)
    dq, dk, dv = torch.zeros_like(q32), torch.zeros_like(k32), torch.zeros_like(v32)

    def tile(x, i):  # rows of q tile i of every head of a group: [B, Hkv, rep * bq, ...]
        t = x[:, :, :, i * bq:(i + 1) * bq]
        return t.reshape(b, hkv, rep * bq, *t.shape[4:])

    for i in range(n_q):
        q_i, do_i, lse_i, delta_i = (tile(x, i) for x in (q32, do32, lse32, delta))
        rows = i * bq + q_offset + torch.arange(bq, device=dev)[:, None]
        last_row = i * bq + bq - 1 + q_offset
        j_end = min(n_k, last_row // bk + 1) if causal else n_k
        dq_i = torch.zeros_like(q_i)
        for j in range(j_end):
            ks = slice(j * bk, (j + 1) * bk)
            k_j, v_j = k32[:, :, ks], v32[:, :, ks]
            s = (q_i @ k_j.transpose(-1, -2)).view(b, hkv, rep, bq, bk)
            cols = j * bk + torch.arange(bk, device=dev)[None, :]
            if pad_k:
                s = s + torch.where(cols < sk, 0.0, NEG_INF)
            if causal:
                s = s + torch.where(rows >= cols, 0.0, NEG_INF)
            s = s.view(b, hkv, rep * bq, bk)
            p = torch.exp2(c * s - lse_i[..., None])
            dp = do_i @ v_j.transpose(-1, -2)
            ds = p * (dp - delta_i[..., None]) * scale
            dq_i += ds @ k_j
            dv[:, :, ks] += p.transpose(-1, -2) @ do_i
            dk[:, :, ks] += ds.transpose(-1, -2) @ q_i
        dq[:, :, :, i * bq:(i + 1) * bq] = dq_i.view(b, hkv, rep, bq, d)

    dq = dq.reshape(b, h, -1, d)[:, :, :sq].permute(0, 2, 1, 3).to(q.dtype)
    dk = dk[:, :, :sk].permute(0, 2, 1, 3).to(k.dtype)
    dv = dv[:, :, :sk].permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``flash_bwd.cu``'s library, built on first use, with its C signatures."""
    lib = _build.load("flash_bwd")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_bwd_dq.argtypes = [p] * 8 + [i] * 7 + [ll] * 5 + [i, i, f, f, p]
    lib.flash_bwd_dq.restype = ctypes.c_int
    lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [ll] * 4 + [i, i, f, f, p]
    lib.flash_bwd_dkv.restype = ctypes.c_int
    return lib


def _launch(q, k, v, out, lse, do, *, causal, scale, q_offset):
    batch, sq, heads, d = q.shape
    _, sk, kv_heads, _ = k.shape
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype == out.dtype == do.dtype:
        raise ValueError(
            "kernels take fp32 or bf16 q/k/v/out/do of one dtype: "
            f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, {do.dtype}"
        )
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape or k.shape[0] != batch:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} must match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (batch * heads, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a dense fp32 [B*H, Sq] = [{batch * heads}, {sq}]: "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if sq < 1 or sk < 1 or q_offset < 0:
        raise ValueError(f"need Sq >= 1, Sk >= 1, q_offset >= 0: {sq}, {sk}, {q_offset}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(name, t)
    if not is_dense(do):  # autograd may hand over an expanded or permuted view
        do = do.contiguous()

    lib = _library()
    delta = torch.empty((batch * heads, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((batch, sq, heads, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((batch, sk, kv_heads, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    common = (_DTYPE_CODES[q.dtype], batch, heads, kv_heads, sq, sk, d)
    c = scale * LOG2_E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch_dq(lib, q, k, v, out, do, lse, delta, dq, common, q_offset, causal, c, scale, stream)
        _launch_dkv(lib, q, k, v, do, lse, delta, dk, dv, common, q_offset, causal, c, scale, stream)
    return dq, dk, dv


def _launch_dq(lib, q, k, v, out, do, lse, delta, dq, common, q_offset, causal, c, scale, stream):
    global dq_launch_count
    err = lib.flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common,
        q.stride(0), k.stride(0), v.stride(0), out.stride(0), do.stride(0),
        q_offset, int(causal), c, scale, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError_t {err}")
    dq_launch_count += 1


def _launch_dkv(lib, q, k, v, do, lse, delta, dk, dv, common, q_offset, causal, c, scale, stream):
    global dkv_launch_count
    err = lib.flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common,
        q.stride(0), k.stride(0), v.stride(0), do.stride(0),
        q_offset, int(causal), c, scale, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError_t {err}")
    dkv_launch_count += 1
