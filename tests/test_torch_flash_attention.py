"""repro_torch attention against repro's: the flash forward (Pallas kernel in
interpret mode on the JAX side, the plain version on the CPU here), the
tiled Algorithm 1, the naive oracle, and the reference attention.  The same
numpy inputs go to both packages.

Tolerances: fp32 3e-5 and bf16 2e-2 on the output, as tests/test_kernels.py
holds the Pallas kernel; the LSE (fp32, |LSE| < 10 here) at 1e-5.  Both
sides run 64 x 64 tiles, so only the order of fp32 sums differs.
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
