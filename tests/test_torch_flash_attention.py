"""repro_torch attention against repro's: the flash forward (Pallas kernel in
interpret mode on the JAX side, the plain version on the CPU here), the
tiled Algorithm 1, the naive oracle, and the reference attention.  The same
numpy inputs go to both packages.

Tolerances: fp32 3e-5 and bf16 2e-2 on the output, as tests/test_kernels.py
holds the Pallas kernel; the LSE (fp32, |LSE| < 10 here) at 1e-5.  Both
sides run 64 x 64 tiles, so only the order of fp32 sums differs.  Also the
SIMT kernel's q-tile choice (``simt_q_tile``), which runs on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_kernels import SHAPE_SWEEP  # noqa: E402

from repro.core.attention import naive_attention as jax_naive  # noqa: E402
from repro.core.attention import systolic_attention as jax_systolic  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro.kernels.flash_attention.ref import attention_reference as jax_reference  # noqa: E402
from repro_torch.core.attention import naive_attention, systolic_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference,
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402

# (B, Sq, Sk, H, Hkv, d, causal): a chunk of a longer prompt, q_offset > 0.
CHUNK_CASE = (1, 48, 112, 4, 2, 16, True)


def _qkv(case, seed=0):
    b, sq, sk, h, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
        rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
    )


def _both(arrays, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("case", SHAPE_SWEEP + [CHUNK_CASE])
def test_flash_fwd_matches_pallas(case, exp2_impl):
    sq, sk, causal = case[1], case[2], case[6]
    qo = sk - sq if causal else 0
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case), "float32")
    kw = dict(causal=causal, q_offset=qo, block_q=64, block_k=64,
              exp2_impl=exp2_impl, return_lse=True)
    ref, ref_lse = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
    out, lse = flash_attention_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :sq], atol=1e-5)


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
def test_flash_fwd_bf16_matches_pallas(exp2_impl):
    case = (1, 128, 128, 2, 2, 64, True)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(case, seed=1), "bfloat16")
    kw = dict(causal=True, block_q=64, block_k=64, exp2_impl=exp2_impl)
    ref = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
    out = flash_attention_fwd(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2
    )


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
def test_flash_fwd_bf16_simt_route_matches_pallas(exp2_impl):
    """bf16 at d 32, the SIMT kernel's other route (P kept in fp32), at its
    64-key tile: GQA rep 2, ragged Sq and Sk, q_offset > 0, with the LSE."""
    case = (1, 100, 164, 4, 2, 32, True)
    tile = flash_kernel.fwd_tile(torch.bfloat16, 32)
    assert flash_kernel.kernel_for(torch.bfloat16, 32) is flash_kernel.SIMT
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(case, seed=4))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    kw = dict(causal=True, q_offset=64, block_q=tile, block_k=tile, exp2_impl=exp2_impl,
              return_lse=True)
    ref, ref_lse = jax_flash_fwd(jq, jk, jv, interpret=True, **kw)
    out, lse = flash_attention_fwd(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :case[1]], atol=1e-5)


# (B, H, Sq): the greedy buckets (64, 256), the fp32 serving and gradient
# shapes, both sides of 132 CTAs of 32 rows, and one row.
Q_TILE_CASES = [
    (1, 16, 64), (1, 16, 256), (1, 16, 2048), (2, 16, 1024),
    (1, 16, 257), (1, 131, 32), (4, 33, 32), (1, 1, 1), (3, 4, 17),
]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("batch,heads,seq_q", Q_TILE_CASES)
def test_simt_q_tile_fills_the_card(batch, heads, seq_q, sms):
    """32-row q tiles where they give a CTA to every SM, else 16-row ones,
    never more than 16 rows when B*H*ceil(Sq/32) < SMs; the grid has one CTA
    per (b*h, q tile)."""
    tile = flash_kernel.simt_q_tile(batch, heads, seq_q, sms)
    grid = batch * heads * -(-seq_q // tile)
    tiles_32 = batch * heads * -(-seq_q // 32)
    assert tile in flash_kernel.SIMT_Q_TILES
    if tiles_32 < sms:
        assert tile == 16 and grid >= tiles_32
    else:
        assert tile == 32 and grid >= sms


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("case", [SHAPE_SWEEP[1], SHAPE_SWEEP[3], CHUNK_CASE])
def test_systolic_attention_matches_reference(case, exp2_impl):
    sq, sk, causal = case[1], case[2], case[6]
    qo = sk - sq if causal else 0
    bias = np.random.default_rng(2).standard_normal((sq, sk)).astype(np.float32)
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(_qkv(case) + (bias,), "float32")
    kw = dict(causal=causal, q_offset=qo, block_q=32, block_k=64, exp2_impl=exp2_impl)
    ref = jax_systolic(jq, jk, jv, bias=jb, **kw)
    out = systolic_attention(tq, tk, tv, bias=tb, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("case", [SHAPE_SWEEP[1], SHAPE_SWEEP[3], CHUNK_CASE])
def test_naive_and_reference_attention_match(case):
    sq, sk, causal = case[1], case[2], case[6]
    qo = sk - sq if causal else 0
    bias = np.random.default_rng(3).standard_normal((sq, sk)).astype(np.float32)
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(_qkv(case) + (bias,), "float32")
    ref = jax_naive(jq, jk, jv, causal=causal, q_offset=qo, bias=jb)
    out = naive_attention(tq, tk, tv, causal=causal, q_offset=qo, bias=tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    ref = jax_reference(jq, jk, jv, causal=causal, q_offset=qo)
    out = attention_reference(tq, tk, tv, causal=causal, q_offset=qo)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper computes the plain version and launches nothing."""
    _, (tq, tk, tv) = _both(_qkv(CHUNK_CASE), "float32")
    before = flash_kernel.launch_count
    kw = dict(causal=True, scale=0.25, q_offset=64, block_q=128, block_k=128,
              exp2_impl="exact", num_segments=8, return_lse=False)
    out = flash_attention(tq, tk, tv, True, None, 64)
    torch.testing.assert_close(out, flash_attention_fwd_plain(tq, tk, tv, **kw), rtol=0, atol=0)
    assert flash_kernel.launch_count == before
