"""The SIMT backward pair's CPU side: the tiles its wrapper chooses, and its
plain version at every tiling the pair runs against the Pallas backward
(the kernels themselves run on the card only, tests/test_torch_cuda.py and
chip_smoke.py).

The SIMT pair (``kernel_bwd.SIMT``, ``csrc/flash_bwd.cu``) streams 64-row
tiles (``SIMT.tile``: the k tile of dQ, the q tile of dK/dV) past a
resident tile of 32 or 16 rows that ``simt_bwd_tiles`` chooses per call
(the q tile of dQ, the k tile of dK/dV).  On the card it is held against
the plain version at the tiles it ran; here that plain version is held
against ``repro``'s Pallas backward in interpret mode on the same numpy
inputs, forward output and LSE, at tests/test_torch_flash_attention_bwd.py's
fp32 3e-5 (only the order of the fp32 sums differs).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_flash_attention_bwd import BWD_CASES, _arrays, _jax_fwd_bwd, _torch  # noqa: E402

from repro_torch.kernels.flash_attention import kernel_bwd  # noqa: E402

STREAMED = kernel_bwd.SIMT.tile
# (block_q, block_k) of each tiling the pair runs: dQ at each q tile, dK/dV
# at each k tile.
TILINGS = [(t, STREAMED) for t in kernel_bwd.SIMT_BWD_TILES] + [
    (STREAMED, t) for t in kernel_bwd.SIMT_BWD_TILES]


@pytest.mark.parametrize("batch,heads,kv_heads,seq_q,seq_k,sms", [
    (1, 16, 16, 64, 64, 132),
    (1, 16, 16, 256, 256, 132),  # the timed short shape: 16-row tiles fill the card
    (1, 16, 16, 264, 264, 132),
    (2, 16, 16, 1024, 1024, 132),  # the fp32 gradient check's shape
    (1, 16, 16, 2048, 2048, 132),
    (1, 8, 2, 256, 256, 132),  # GQA: fewer dK/dV CTAs than dQ CTAs
    (1, 32, 8, 100, 1000, 132),
    (1, 1, 1, 1, 17, 132),  # nothing fills the card: the most CTAs
    (2, 4, 1, 17, 300, 114),
    (1, 16, 16, 256, 256, 114),
    (4, 16, 16, 2048, 2048, 114),
])
def test_simt_bwd_tiles_fill_the_card(batch, heads, kv_heads, seq_q, seq_k, sms):
    """Each resident tile is one the kernels were built for; it gives at
    least as many CTAs as SMs wherever a smaller tile can, 32 rows where
    32 do, and the smallest tile where none fills the card."""
    block_q, block_k = kernel_bwd.simt_bwd_tiles(batch, heads, kv_heads, seq_q, seq_k, sms)
    smallest = min(kernel_bwd.SIMT_BWD_TILES)
    for tile, rows, seq in ((block_q, batch * heads, seq_q), (block_k, batch * kv_heads, seq_k)):
        assert tile in kernel_bwd.SIMT_BWD_TILES
        ctas = rows * -(-seq // tile)
        if rows * -(-seq // smallest) >= sms:
            assert ctas >= sms
        else:
            assert tile == smallest
        assert (tile == 32) == (rows * -(-seq // 32) >= sms)


@functools.lru_cache(maxsize=None)
def _reference(case, exp2_impl):
    """The reference's forward output and LSE and its Pallas backward, on
    BWD_CASES' fp32 inputs."""
    arrays = _arrays(case)
    out, lse, grads, qo = _jax_fwd_bwd(case, arrays, jnp.float32, exp2_impl)
    return arrays, out, lse, grads, qo


@pytest.mark.parametrize("block_q,block_k", TILINGS)
@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_at_simt_tiles_matches_pallas(case, exp2_impl, block_q, block_k):
    """The plain version at each tiling the SIMT pair runs, with the LSE of
    an exact or a PWL forward (the backward's exp2 is exact either way)."""
    arrays, out, lse, ref, qo = _reference(case, exp2_impl)
    q, k, v, do = (_torch(a) for a in arrays)
    got = kernel_bwd.flash_attention_bwd_plain(
        q, k, v, _torch(out), _torch(lse)[:, :case[1]], do, causal=case[6],
        scale=case[5] ** -0.5, q_offset=qo, block_q=block_q, block_k=block_k,
    )
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)
