"""FlashAttention-2 backward: wrapper of the hand-written CUDA kernels in
``kernels/csrc/flash_bwd_sm90.cu`` and ``kernels/csrc/flash_bwd.cu``, the
ports of the Pallas TPU kernels
``repro.kernels.flash_attention.kernel_bwd._dq_kernel`` and ``_dkv_kernel``.

``flash_attention_bwd`` keeps the reference's signature and ``[B, S, H, d]``
layout and takes the unpadded ``[B * H, Sq]`` base-2 LSE of
``flash_attention_fwd``. P = exp2(c S - LSE) is recomputed per tile, never
stored, always with the exact exp2 (also after a PWL forward, as the
reference's backward does). A tensor on the card launches two kernels, dQ
(which also computes delta = rowsum(dO * O) and writes it for the second)
and then dK/dV, which sums the ``rep`` q heads of its GQA group. Neither
needs atomics, so the result is deterministic. A tensor on the CPU takes
the plain version (``flash_attention_bwd_plain``).

The table ``BWD_KERNELS`` chooses the pair from ``(dtype, head_dim)``, as
the forward's ``KERNELS`` does; each ``BwdKernel`` record holds what the
choice implies:

* ``SM90`` (``flash_bwd_sm90.cu``) for bf16 at d 64 and 128: wgmma on the
  tensor cores, TMA loads, a producer warpgroup and two consumer
  warpgroups. P is rounded to bf16 for dV = P^T dO and dS for dQ = dS K
  and dK = dS^T Q (both computed in fp32 from the fp32 S and dP;
  departure (e), ROADMAP queue 3);
* ``SIMT`` (``flash_bwd.cu``) for fp32 at d 16 to 128 and bf16 at d 16
  and 32: register-blocked fp32 FMAs on the CUDA cores, P and dS kept in
  fp32 (the reference's numerics), two CTAs an SM, each loading its
  streamed 64-row tiles by cp.async while a product that does not read
  them runs; a resident tile of 32 or 16 rows (the q tile of dQ, the k tile
  of dK/dV) that the wrapper chooses per call (``simt_bwd_tiles``: 16 where
  32 would leave SMs idle).

Nothing falls back: a CUDA tensor the chosen pair cannot take raises. The
plain version mirrors the pair that ``BWD_KERNELS`` gives its inputs: it
rounds P and dS where that pair does (``fp32_p=True`` keeps the
reference's fp32 numerics). ``block_q`` and ``block_k`` set its tiles; the
kernels' streamed tiles are fixed (``bwd_tile``), and the SIMT pair's
resident tiles vary (``simt_bwd_tiles``). Tiles change only the order of
the fp32 sums: masked entries give P = 0 exactly, on any tiling.

GQA (departure (b) from the reference, ROADMAP queue 3): the reference
rounds each q head's dK/dV partial to k's dtype and then sums the group;
here the group is summed in fp32 and rounded once. In fp32 the two agree
to the order of the sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.attention import NEG_INF, _pad_seq
from repro_torch.core.pwl_exp2 import LOG2_E
from repro_torch.kernels import _build
from .kernel import (
    DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, HEAD_DIMS, _DTYPE_CODES, _sm_count, check_tma_layout, is_dense,
)


class BwdKernel(NamedTuple):
    """One backward pair: its name, its library, its C entry points (dQ
    with delta, then dK/dV; each pair takes flash_bwd.cu's arguments, the
    SIMT pair its resident tile after them, and the entry names are the
    keys of ``launch_counts``), its streamed tile (the plain version's when
    held against it: the k tile of dQ, the q tile of dK/dV), and the dtype
    it rounds P and dS to for their products (None: fp32)."""

    name: str
    library: str
    entries: tuple[str, str]
    tile: int
    rounds: Optional[torch.dtype]


SM90 = BwdKernel("sm90", "flash_bwd_sm90", ("flash_bwd_sm90_dq", "flash_bwd_sm90_dkv"), 64, torch.bfloat16)
SIMT = BwdKernel("simt", "flash_bwd", ("flash_bwd_dq", "flash_bwd_dkv"), 64, None)

# (dtype, head_dim) -> the backward pair that takes it on the card.
BWD_KERNELS = {
    **{(torch.float32, d): SIMT for d in HEAD_DIMS},
    (torch.bfloat16, 16): SIMT,
    (torch.bfloat16, 32): SIMT,
    (torch.bfloat16, 64): SM90,
    (torch.bfloat16, 128): SM90,
}

# flash_bwd_sm90.cu's dQ work tile (kBlock): its delta and padded LSE have
# Sq rounded up to this many rows.
SM90_STATS_ROWS = 128

# Launches in this process by C entry point; callers reset and read them to
# show that a path went through the kernels.  ``dq_launch_count`` and
# ``dkv_launch_count`` are the sums over the pairs.
launch_counts = {entry: 0 for kernel in (SM90, SIMT) for entry in kernel.entries}


def __getattr__(name: str):
    if name in ("dq_launch_count", "dkv_launch_count"):
        side = 0 if name == "dq_launch_count" else 1
        return sum(launch_counts[kernel.entries[side]] for kernel in (SM90, SIMT))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def bwd_kernel_for(dtype: torch.dtype, head_dim: int) -> BwdKernel:
    """The pair that ``BWD_KERNELS`` gives ``(dtype, head_dim)``; raises
    ``ValueError`` where there is none."""
    try:
        return BWD_KERNELS[(dtype, head_dim)]
    except KeyError:
        raise ValueError(
            f"no backward kernel for {dtype} at head_dim {head_dim} "
            f"(fp32 or bf16, head_dim in {HEAD_DIMS})"
        ) from None


def bwd_tile(dtype: torch.dtype, head_dim: int) -> int:
    """The streamed tile of the pair that takes ``(dtype, head_dim)``: the
    plain version's tiles when it is held against that pair (the SIMT
    pair's other tiles: ``simt_bwd_tiles``)."""
    return bwd_kernel_for(dtype, head_dim).tile


SIMT_BWD_TILES = (32, 16)


def simt_bwd_tiles(batch: int, heads: int, kv_heads: int, seq_q: int, seq_k: int,
                   sms: int) -> tuple[int, int]:
    """The SIMT pair's resident tiles ``(block_q, block_k)``: the q tile of
    dQ (one CTA per (b*h, q tile)) and the k tile of dK/dV (one CTA per
    (b, kv head, k tile)), each 32 rows, or 16 where 32-row tiles give fewer
    CTAs than the card has SMs."""
    def tile(rows: int, seq: int) -> int:
        return 32 if rows * -(-seq // 32) >= sms else 16
    return tile(batch * heads, seq_q), tile(batch * kv_heads, seq_k)


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

    ``block_q`` and ``block_k`` set the plain version's tiles; the kernels
    choose their own (``bwd_tile``, ``simt_bwd_tiles``)."""
    if not q.shape[2] % k.shape[2] == 0:
        raise ValueError(f"heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    tensors = (q, k, v, out, lse, do)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    if q.device.type in ("cpu", "meta"):  # meta: a shape-only trace (the dry-run)
        return flash_attention_bwd_plain(*tensors, block_q=block_q, block_k=block_k, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(*tensors, **kw)


def flash_attention_bwd_plain(
    q, k, v, out, lse, do, *, causal, scale, q_offset, block_q, block_k, fp32_p=False,
):
    """The plain PyTorch version of the pair that ``BWD_KERNELS`` gives
    these inputs, on any device: FA-2 in fp32 over ``block_q`` x ``block_k``
    tiles, the q heads of a GQA group folded into the rows of one product
    (so dK and dV sum the group in fp32). P (for dV) and dS (for dQ and dK)
    are rounded to bf16 as product operands where that pair rounds them,
    unless ``fp32_p``. Causal tiles wholly above the diagonal are skipped: P
    is 0 there."""
    kernel = BWD_KERNELS.get((q.dtype, q.shape[-1]))
    rounds = None if fp32_p or kernel is None else kernel.rounds

    def operand(x):  # P or dS as the pair's products take it
        return x if rounds is None else x.to(rounds).float()

    dq, dk, dv = _fa2(q, k, v, out, lse, do, causal=causal, scale=scale, q_offset=q_offset,
                      block_q=block_q, block_k=block_k, operand=operand, magnitudes=False)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def departure_bound(q, k, v, out, lse, do, *, causal, scale, q_offset, block_q=64, block_k=64):
    """How far rounding P and dS to bf16 as product operands (departure
    (e)) can move each gradient from the fp32-P plain version, element by
    element: ``2**-8 * (|dS| |K|, |dS|^T |Q|, P^T |dO|)`` in fp32 for dQ, dK
    and dV (each rounding moves its operand by at most 2**-8 of itself).
    A check adds one bf16 step of the result (both sides round it) and
    1e-3 for values near zero."""
    dq, dk, dv = _fa2(q, k, v, out, lse, do, causal=causal, scale=scale, q_offset=q_offset,
                      block_q=block_q, block_k=block_k, operand=lambda x: x, magnitudes=True)
    return tuple(2.0 ** -8 * g for g in (dq, dk, dv))


def _fa2(q, k, v, out, lse, do, *, causal, scale, q_offset, block_q, block_k, operand, magnitudes):
    """FA-2's backward in fp32 (``[B, S, H, d]`` fp32 results), P and dS
    passed through ``operand`` before their products; with ``magnitudes``
    the products take |dS|, |K|, |Q| and |dO| instead (P >= 0)."""
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
    mag = torch.abs if magnitudes else (lambda x: x)

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
            ds = mag(operand(p * (dp - delta_i[..., None]) * scale))
            dq_i += ds @ mag(k_j)
            dv[:, :, ks] += operand(p).transpose(-1, -2) @ mag(do_i)
            dk[:, :, ks] += ds.transpose(-1, -2) @ mag(q_i)
        dq[:, :, :, i * bq:(i + 1) * bq] = dq_i.view(b, hkv, rep, bq, d)

    dq = dq.reshape(b, h, -1, d)[:, :, :sq].permute(0, 2, 1, 3)
    return dq, dk[:, :, :sk].permute(0, 2, 1, 3), dv[:, :, :sk].permute(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """The library of a pair (``BwdKernel.library``), built on first use,
    with the C signatures of its two entry points."""
    lib = _build.load(name)
    kernel = next(k for k in (SM90, SIMT) if k.library == name)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    dq, dkv = (getattr(lib, entry) for entry in kernel.entries)
    dq.argtypes = [p] * 8 + [i] * 7 + [ll] * 5 + [i, i, f, f, p]
    dkv.argtypes = [p] * 8 + [i] * 7 + [ll] * 4 + [i, i, f, f, p]
    if kernel is SIMT:  # the resident tile
        dq.argtypes.append(i)
        dkv.argtypes.append(i)
    dq.restype = dkv.restype = ctypes.c_int
    return lib


def _launch(q, k, v, out, lse, do, *, causal, scale, q_offset, tiles=None):
    """Launch the pair that ``BWD_KERNELS`` gives the inputs; ``tiles``
    overrides ``simt_bwd_tiles`` for the SIMT pair (to time each tile)."""
    batch, sq, heads, d = q.shape
    _, sk, kv_heads, _ = k.shape
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype == out.dtype == do.dtype:
        raise ValueError(
            "kernels take fp32 or bf16 q/k/v/out/do of one dtype: "
            f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, {do.dtype}"
        )
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape != k.shape or k.shape[0] != batch:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    kernel = bwd_kernel_for(q.dtype, d)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} must match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (batch * heads, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a dense fp32 [B*H, Sq] = [{batch * heads}, {sq}]: "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if sq < 1 or sk < 1 or q_offset < 0:
        raise ValueError(f"need Sq >= 1, Sk >= 1, q_offset >= 0: {sq}, {sk}, {q_offset}")
    do = check_layouts(kernel, q, k, v, out, do)
    if kernel is SIMT:
        if tiles is None:
            tiles = simt_bwd_tiles(batch, heads, kv_heads, sq, sk, _sm_count(q.device))
        if not all(t in SIMT_BWD_TILES for t in tiles):
            raise ValueError(f"SIMT backward tiles must be in {SIMT_BWD_TILES}: {tiles}")
    else:
        tiles = (None, None)

    delta, lse_dkv = _row_stats(kernel, lse)
    dq = torch.empty((batch, sq, heads, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((batch, sk, kv_heads, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    common = (_DTYPE_CODES[q.dtype], batch, heads, kv_heads, sq, sk, d)
    c = scale * LOG2_E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch_dq(kernel, q, k, v, out, do, lse, delta, dq, common, q_offset, causal, c, scale, stream,
                   tiles[0])
        _launch_dkv(kernel, q, k, v, do, lse_dkv, delta, dk, dv, common, q_offset, causal, c, scale, stream,
                    tiles[1])
    return dq, dk, dv


def check_layouts(kernel: BwdKernel, q, k, v, out, do) -> torch.Tensor:
    """Raise ``ValueError`` unless ``kernel`` can take these ``[B, S, H, d]``
    tensors: what a TMA tensor map (``SM90``) and 16-byte ``cp.async``
    copies (``SIMT``) need, ``check_tma_layout``; return dO, made dense
    first if it was not (autograd may hand over an expanded or permuted
    view). Reads only shapes, strides and addresses, so it runs on CPU
    tensors too."""
    if not is_dense(do):
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)):
        check_tma_layout(name, t)
    return do


def _row_stats(kernel: BwdKernel, lse: torch.Tensor):
    """``(delta, lse for dK/dV)``: the buffer the dQ kernel writes delta
    into, and the LSE the dK/dV kernel reads. For ``SM90`` both are halves
    of one ``[2, B*H, Sq']`` buffer (flash_bwd_sm90.cu: Sq rounded up to
    ``SM90_STATS_ROWS``; the dQ kernel writes delta and the LSE padded with
    +inf); for ``SIMT`` delta is ``[B*H, Sq]`` and the LSE is the forward's."""
    bh, sq = lse.shape
    if kernel is SM90:
        rows = -(-sq // SM90_STATS_ROWS) * SM90_STATS_ROWS
        delta, lse_dkv = torch.empty((2, bh, rows), dtype=torch.float32, device=lse.device)
        return delta, lse_dkv
    return torch.empty((bh, sq), dtype=torch.float32, device=lse.device), lse


def _check(entry: str, err: int) -> None:
    if err != 0:
        # flash_bwd_sm90.cu: 900, libcuda has no cuTensorMapEncodeTiled;
        # 1000 + CUresult, libcuda refused a tensor map. flash_bwd.cu: 716,
        # a base or batch stride off 16 bytes.
        raise RuntimeError(f"{entry} kernel launch failed: error {err}")
    launch_counts[entry] += 1


def _launch_dq(kernel, q, k, v, out, do, lse, delta, dq, common, q_offset, causal, c, scale, stream,
               tile=None):
    """The dQ kernel of ``kernel``; ``tile``: the SIMT pair's q tile."""
    entry = kernel.entries[0]
    err = getattr(_library(kernel.library), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common,
        q.stride(0), k.stride(0), v.stride(0), out.stride(0), do.stride(0),
        q_offset, int(causal), c, scale, stream, *(() if tile is None else (tile,)),
    )
    _check(entry, err)


def _launch_dkv(kernel, q, k, v, do, lse, delta, dk, dv, common, q_offset, causal, c, scale, stream,
                tile=None):
    """The dK/dV kernel of ``kernel``; ``tile``: the SIMT pair's k tile."""
    entry = kernel.entries[1]
    err = getattr(_library(kernel.library), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common,
        q.stride(0), k.stride(0), v.stride(0), do.stride(0),
        q_offset, int(causal), c, scale, stream, *(() if tile is None else (tile,)),
    )
    _check(entry, err)
