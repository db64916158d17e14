"""repro_torch's flash-attention backward against repro's: the plain FA-2
version (what a CPU tensor takes) against the Pallas dq/dkv kernels in
interpret mode on the same forward output, LSE and dO, and the
differentiable ``flash_attention`` against ``jax.grad`` of the reference's.

Tolerances: fp32 3e-5, as tests/test_kernels.py holds the Pallas backward
against autodiff (both sides run fp32 products over 64 x 64 tiles, only
the order of the sums differs); bf16 2e-2 + 2**-6 |ref|: both sides round
each gradient to bf16 from fp32 sums (one bf16 step, 2**-7 of the value,
apart at most), and the reference also rounds each q head's dK/dV partial
before summing the GQA group (one step more); gradients reach |5| here, so
the forward's bf16 2e-2 alone is not enough.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_flash_bwd  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd  # noqa: E402

# (B, Sq, Sk, H, Hkv, d, causal): the cases of tests/test_kernels.py's
# backward test (the last ragged, with GQA and a causal offset).
BWD_CASES = [
    (1, 128, 128, 2, 1, 32, True),
    (2, 256, 192, 4, 2, 64, False),
    (1, 100, 200, 4, 1, 32, True),
]


def _arrays(case, seed=0):
    b, sq, sk, h, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_fwd_bwd(case, arrays, dtype, exp2_impl):
    """The reference's forward (output, padded LSE) and its Pallas backward."""
    sq, sk, causal = case[1], case[2], case[6]
    qo = sk - sq if causal else 0
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrays)
    kw = dict(causal=causal, q_offset=qo, block_q=64, block_k=64, interpret=True)
    out, lse = jax_flash_fwd(jq, jk, jv, exp2_impl=exp2_impl, return_lse=True, **kw)
    grads = jax_flash_bwd(jq, jk, jv, out, lse, jdo, **kw)
    return out, lse, grads, qo


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_plain_matches_pallas(case, exp2_impl):
    """With the PWL forward's LSE too: the backward always uses exact exp2."""
    arrays = _arrays(case)
    out, lse, ref, qo = _jax_fwd_bwd(case, arrays, jnp.float32, exp2_impl)
    q, k, v, do = (_torch(a) for a in arrays)
    got = flash_attention_bwd(
        q, k, v, _torch(out), _torch(lse)[:, :case[1]], do,
        causal=case[6], q_offset=qo, block_q=64, block_k=64,
    )
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5)


def test_bwd_bf16_gqa_sums_the_group_once():
    """bf16 with GQA (rep 2): within one bf16 rounding of the reference, and
    dK/dV are the fp32 group sums rounded once (ROADMAP queue 3, departure
    (b)): with the reference's fp32 P and dS (``fp32_p``), exactly what the
    same computation on fp32 inputs gives, rounded.  The CPU path rounds P
    and dS to bf16 as the sm90 pair does (departure (e),
    tests/test_torch_flash_bwd_sm90.py)."""
    case = (1, 128, 128, 4, 2, 64, True)
    arrays = _arrays(case, seed=1)
    out, lse, ref, qo = _jax_fwd_bwd(case, arrays, jnp.bfloat16, "exact")
    inputs16 = [_torch(a, torch.bfloat16) for a in arrays]
    q, k, v, do = inputs16
    o16 = _torch(np.asarray(out, np.float32), torch.bfloat16)
    lse = _torch(lse)[:, :case[1]]
    kw = dict(causal=True, q_offset=qo, block_q=64, block_k=64)
    got = flash_attention_bwd(q, k, v, o16, lse, do, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(r, np.float32), atol=2e-2, rtol=2.0 ** -6
        )
    q32, k32, v32, do32, o32 = (t.float() for t in (q, k, v, do, o16))
    once = flash_attention_bwd_plain(q32, k32, v32, o32, lse, do32, scale=64 ** -0.5, **kw)
    fp32_p = flash_attention_bwd_plain(q, k, v, o16, lse, do, scale=64 ** -0.5, fp32_p=True, **kw)
    for g, r in zip(fp32_p, once):
        torch.testing.assert_close(g, r.to(torch.bfloat16), rtol=0, atol=0)


def _port_grads(arrays, exp2_impl, causal=True):
    q, k, v = (_torch(a).requires_grad_() for a in arrays[:3])
    out = flash_attention(q, k, v, causal, None, 0, 64, 64, exp2_impl, 8)
    return torch.autograd.grad((out * out).sum(), (q, k, v))


def _jax_grads(arrays, exp2_impl, impl):
    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, True, None, 0, 64, 64, exp2_impl, 8, impl, True)
        return (o * o).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]))


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
def test_autograd_matches_pallas_custom_vjp(exp2_impl):
    """End to end: the reference's ``"pallas"`` flash_attention (its custom
    VJP over the Pallas kernels) and the port's autograd.Function, on the
    shapes of tests/test_kernels.py's custom-VJP test."""
    arrays = _arrays((1, 128, 128, 2, 1, 32, True), seed=2)
    ref = _jax_grads(arrays, exp2_impl, "pallas")
    for g, r in zip(_port_grads(arrays, exp2_impl), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def test_systolic_gradients_are_the_pallas_ones():
    """ROADMAP queue 3, departure (a): the port runs the kernel for
    ``attention_impl="systolic"``, whose backward is exact-exp2 FA-2.  With
    the exact exp2 that agrees with the reference's ``"systolic"`` path (it
    differentiates its jnp scan); with the PWL exp2 it is the reference's
    ``"pallas"`` gradient, not the gradient of the PWL function."""
    arrays = _arrays((1, 128, 128, 2, 1, 32, True), seed=3)
    exact = _port_grads(arrays, "exact")
    for g, r in zip(exact, _jax_grads(arrays, "exact", "jnp")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)
    pwl = _port_grads(arrays, "pwl")
    systolic_pwl = _jax_grads(arrays, "pwl", "jnp")
    for g, r in zip(pwl, _jax_grads(arrays, "pwl", "pallas")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)
    gap = max(float(np.abs(g.numpy() - np.asarray(r)).max()) for g, r in zip(pwl, systolic_pwl))
    assert gap > 1e-3, gap  # the two reference paths differ by far more than tolerance


def test_cpu_backward_takes_the_plain_version():
    """On the CPU the gradient comes from the plain version; no kernel runs,
    and an expanded dO (the gradient of ``out.sum()``) is taken as it is."""
    arrays = _arrays(BWD_CASES[2])
    q, k, v = (_torch(a).requires_grad_() for a in arrays[:3])
    before = (flash_kernel.launch_count, kernel_bwd.dq_launch_count, kernel_bwd.dkv_launch_count)
    out = flash_attention(q, k, v, True, None, 100, 64, 64)
    got = torch.autograd.grad(out.sum(), (q, k, v))
    after = (flash_kernel.launch_count, kernel_bwd.dq_launch_count, kernel_bwd.dkv_launch_count)
    assert after == before
    with torch.no_grad():
        out, lse = flash_kernel.flash_attention_fwd(
            q, k, v, causal=True, q_offset=100, block_q=64, block_k=64, return_lse=True
        )
        ref = flash_attention_bwd_plain(
            q, k, v, out, lse, torch.ones_like(out),
            causal=True, scale=32 ** -0.5, q_offset=100, block_q=64, block_k=64,
        )
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_no_grad_forward_keeps_no_graph():
    """Without a gradient to take, ``flash_attention`` returns a plain tensor
    (the serving path: one forward launch, no LSE)."""
    arrays = _arrays(BWD_CASES[0])
    q, k, v = (_torch(a).requires_grad_() for a in arrays[:3])
    with torch.no_grad():
        out = flash_attention(q, k, v, True)
    assert out.grad_fn is None
    assert flash_attention(q, k, v, True).grad_fn is not None
