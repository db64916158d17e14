"""The tensor-core forward's CPU side: its plain twin, the kernel table and
the TMA layout checks (the kernel itself runs on the card only,
tests/test_torch_cuda.py and chip_smoke.py).

bf16 at head width 64 and 128 goes to ``flash_fwd_sm90.cu``, which rounds P
to bf16 for the PV product and sums l from the fp32 P.  Its plain twin,
``flash_attention_fwd_plain``, does the same; it is held here against the
Pallas kernel of ``repro`` in interpret mode, which keeps P in fp32, on the
same bf16 numpy inputs, at both sides' 128 x 128 tiles (with the PWL exp2 the
LSE depends on where the k tiles break).

Tolerances: the output at bf16's 2e-2, as tests/test_kernels.py holds the
Pallas kernel in bf16 (P's rounding moves it by at most 2**-8 of the
attention-weighted |v|, see ``_departure_tol``); the LSE at 1e-5, as tests/test_torch_flash_attention.py
holds it in fp32, since l and m never see the rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro_torch.core.attention import systolic_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402

TILE = flash.SM90.tile

# (B, Sq, Sk, H, Hkv, d, causal, q_offset): GQA rep 1, 2 and 4; Sq and Sk
# off the 128-row tile; q_offset off the tile; one tile and several.
CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 100, 200, 4, 2, 64, True, 100),
    (1, 17, 300, 8, 2, 64, True, 283),
    (1, 1, 130, 4, 1, 128, True, 129),
    (1, 150, 150, 2, 1, 128, False, 0),
]


def _qkv(case, seed):
    b, sq, sk, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _bf16(arrays):
    """The same bf16 values on both sides."""
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    return (jq, jk, jv), (tq, tk, tv)


def _departure_tol(ref, weighted_abs_v):
    """|bf16-P - fp32-P| bound, element by element: o = sum p_j v_j / l with
    l from the fp32 P in both, so rounding each p_j (by at most 2**-8 of it)
    moves o by at most 2**-8 * sum p_j |v_j| / l, the fp32-P plain version's
    output on |v|; each output is then rounded to bf16 (one step, 2**-7 of
    the value); 1e-3 covers outputs near zero (chip_smoke.TOL_FP32P)."""
    return 1e-3 + 2.0 ** -8 * weighted_abs_v.float() + 2.0 ** -7 * ref.float().abs()


@pytest.mark.parametrize("return_lse", [True, False])
@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("case", CASES)
def test_plain_twin_matches_pallas(case, exp2_impl, return_lse):
    causal, q_offset = case[6], case[7]
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(case, seed=0))
    kw = dict(causal=causal, q_offset=q_offset, exp2_impl=exp2_impl, num_segments=8,
              return_lse=return_lse)
    ref = jax_flash_fwd(jq, jk, jv, block_q=TILE, block_k=TILE, interpret=True, **kw)
    out = flash.flash_attention_fwd_plain(
        tq, tk, tv, block_q=TILE, block_k=TILE, scale=1.0 / np.sqrt(case[5]), **kw)
    if return_lse:
        (ref, ref_lse), (out, lse) = ref, out
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :case[1]], atol=1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_bf16_p_departs_within_its_bound_and_keeps_the_lse(case, exp2_impl):
    """The twin against the fp32-P plain version: outputs within the bound of
    P's rounding (and not all equal: the rounding is there), the LSE the
    same bits (l is summed before the rounding)."""
    _, (tq, tk, tv) = _bf16(_qkv(case, seed=1))
    kw = dict(causal=case[6], scale=1.0 / np.sqrt(case[5]), q_offset=case[7], block_q=TILE,
              block_k=TILE, exp2_impl=exp2_impl, num_segments=8, return_lse=True)
    out, lse = flash.flash_attention_fwd_plain(tq, tk, tv, **kw)
    ref, ref_lse = flash.flash_attention_fwd_plain(tq, tk, tv, fp32_p=True, **kw)
    weighted_abs_v = flash.flash_attention_fwd_plain(
        tq, tk, tv.abs(), fp32_p=True, **dict(kw, return_lse=False))
    err = (out.float() - ref.float()).abs()
    assert bool((err <= _departure_tol(ref, weighted_abs_v)).all()), float(err.max())
    assert float(err.max()) > 0.0
    assert torch.equal(lse, ref_lse)


@pytest.mark.parametrize("dtype,head_dim,kernel", [
    (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 16, "simt"),
    (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 32, "simt"),
    (torch.float32, 16, "simt"),
    (torch.float16, 128, None),
    (torch.bfloat16, 80, None),
    (torch.float32, 48, None),
])
def test_kernel_table(dtype, head_dim, kernel):
    """``KERNELS`` picks the kernel from (dtype, head_dim); what it lacks raises."""
    if kernel is None:
        with pytest.raises(ValueError):
            flash.kernel_for(dtype, head_dim)
        return
    chosen = flash.kernel_for(dtype, head_dim)
    assert chosen.name == kernel
    assert chosen.entry == ("flash_fwd_sm90" if kernel == "sm90" else "flash_fwd")
    assert flash.fwd_tile(dtype, head_dim) == chosen.tile == (128 if kernel == "sm90" else 64)
    assert chosen.p_dtype == (torch.bfloat16 if kernel == "sm90" else None)


def _bshd(b, s, h, d):
    return torch.zeros((b, s, h, d), dtype=torch.bfloat16)


def _misaligned(t):
    """A view of ``t``'s shape whose base lies 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    start = (-flat.data_ptr() // 2) % 8 + 1
    return flat[start:start + t.numel()].view(t.shape)


@pytest.mark.parametrize("layout,ok", [
    ("dense", True),
    ("kv_cache_prefix", True),
    ("one_batch_any_stride", True),
    ("misaligned_base", False),
    ("misaligned_batch_stride", False),
    ("not_dense", False),
])
def test_tma_layout_checks(layout, ok):
    """What a TMA tensor map can describe, checked on CPU tensors."""
    t = {
        "dense": lambda: _bshd(2, 100, 4, 128),
        # [B, capacity, Hkv, d] cut to the first 700 positions.
        "kv_cache_prefix": lambda: _bshd(2, 1024, 2, 128)[:, :700],
        "one_batch_any_stride": lambda: torch.as_strided(
            torch.zeros(64 * 64 + 8, dtype=torch.bfloat16), (1, 8, 8, 64), (64 * 64 + 3, 512, 64, 1)),
        "misaligned_base": lambda: _misaligned(_bshd(2, 100, 4, 64)),
        "misaligned_batch_stride": lambda: torch.as_strided(
            torch.zeros(2 * 100 * 4 * 64 + 8, dtype=torch.bfloat16), (2, 100, 4, 64),
            (100 * 4 * 64 + 4, 4 * 64, 64, 1)),
        "not_dense": lambda: _bshd(2, 4, 100, 64).transpose(1, 2),
    }[layout]()
    if ok:
        flash.check_tma_layout("k", t)
    else:
        with pytest.raises(ValueError):
            flash.check_tma_layout("k", t)


@pytest.mark.parametrize("dtype,head_dim,rounds", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 32, False),
    (torch.float32, 64, False),
])
def test_cpu_path_computes_what_the_card_computes(dtype, head_dim, rounds):
    """On the CPU the wrapper runs the plain twin of the kernel the card would
    run: P rounded to bf16 exactly where that kernel rounds it.  The
    reference path ``systolic_attention`` keeps the fp32 P."""
    case = (1, 150, 150, 2, 1, head_dim, True, 0)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in _qkv(case, seed=2))
    kw = dict(causal=True, scale=head_dim ** -0.5, q_offset=0, block_q=TILE, block_k=TILE,
              exp2_impl="exact", num_segments=8, return_lse=False)
    out = flash.flash_attention_fwd(tq, tk, tv, **kw)
    fp32_p = flash.flash_attention_fwd_plain(tq, tk, tv, fp32_p=True, **kw)
    torch.testing.assert_close(out, flash.flash_attention_fwd_plain(tq, tk, tv, **kw), rtol=0, atol=0)
    assert torch.equal(out, fp32_p) != rounds
    reference = systolic_attention(tq, tk, tv, causal=True, block_q=TILE, block_k=TILE)
    torch.testing.assert_close(reference, fp32_p, rtol=0, atol=0)
