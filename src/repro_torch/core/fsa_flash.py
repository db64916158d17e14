"""The paper's Listing 2: FlashAttention as an FSA kernel.

Single-head FlashAttention forward on the FSA device simulator using the
§5 Python programming model, with the exact tile/loop structure of the
paper's open-source kernel: Q stationary per inner iteration, K streamed,
V pre-transposed, double-buffered scratchpad tiles, log-expsum and O
accumulated in accumulation SRAM, LSE-normalized once per outer iteration.
A numpy copy of ``repro.core.fsa_flash``.
"""

from __future__ import annotations

import numpy as np

from . import fsa_kernel_api as F

__all__ = ["fsa_flash_attention"]


def fsa_flash_attention(
    q: np.ndarray,  # [LEN, d]
    k: np.ndarray,  # [LEN, d]
    v: np.ndarray,  # [LEN, d]
    *,
    array_n: int = 128,
    num_segments: int = 8,
    spad_bytes: int = 192 * 1024,
    accum_bytes: int | None = None,
    single_direction: bool = False,
) -> F.KernelResult:
    """Run one attention head through the FSA simulator; returns KernelResult.

    Tiling per §3.5: Br = N_COLS, Bc = N_ROWS = d = array_n.
    """
    seq, d = q.shape
    assert d == array_n, f"FSA maps Bc = N_ROWS = d (= {array_n}); got d={d}"
    assert seq % array_n == 0, (seq, array_n)
    br = bc = array_n
    scale = 1.0 / float(np.sqrt(d))
    vt = np.ascontiguousarray(v.T)  # host-side pre-transpose (paper §5.3)

    # The paper's 64 KiB accumulation SRAM holds one O tile + one l tile
    # (128*128*4 + 128*4 bytes); size it exactly unless overridden.
    if accum_bytes is None:
        accum_bytes = d * br * 4 + br * 4

    @F.kernel(array_n=array_n, num_segments=num_segments,
              spad_bytes=spad_bytes, accum_bytes=accum_bytes,
              single_direction=single_direction)
    def attention(Q: F.MTile, K: F.MTile, Vt: F.MTile) -> F.MTile:
        Ot = F.alloc_mem((d, seq), np.float32, name="Ot")
        Ot_tiles = Ot.split(br, dim=-1)     # [d, br]
        Q_tiles = Q.split(br, dim=-2)       # [br, d]
        K_tiles = K.split(bc, dim=-2)       # [bc, d]
        Vt_tiles = Vt.split(bc, dim=-1)     # [d, bc]

        # double buffering for Q, K, Vt (paper Listing 2)
        Q_spad = (F.alloc_spad((br, d)), F.alloc_spad((br, d)))
        K_spad = (F.alloc_spad((bc, d)), F.alloc_spad((bc, d)))
        Vt_spad = (F.alloc_spad((d, bc)), F.alloc_spad((d, bc)))

        log_expsum = F.alloc_accum((1, br))
        Ot_accum = F.alloc_accum((d, br))

        for i, Q_i in enumerate(Q_tiles):
            F.load_tile(Q_i, Q_spad[i % 2])
            # reset accumulators for this Q tile
            _zero(log_expsum)
            _zero(Ot_accum)
            for j, (K_j, Vt_j) in enumerate(zip(K_tiles, Vt_tiles)):
                F.load_stationary(Q_spad[i % 2], transpose=True, reset_stats=(j == 0))
                F.load_tile(K_j, K_spad[j % 2])
                F.attn_score(K_spad[j % 2], log_expsum, scale=scale)
                F.load_tile(Vt_j, Vt_spad[j % 2])
                F.attn_value(Vt_spad[j % 2], Ot_accum)
            F.reciprocal(log_expsum)
            F.attn_lse_norm(Ot_accum)
            F.store_tile(Ot_accum, Ot_tiles[i])
        return Ot

    def _zero(tile):
        dev = F._ctx().device
        tile._write(dev.accum, np.zeros(tile.shape, np.float32))

    res = attention(q, k, vt)
    res.output = np.ascontiguousarray(res.output.T)  # host-side transpose back
    return res
