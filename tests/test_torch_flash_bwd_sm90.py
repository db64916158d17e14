"""The tensor-core backward's CPU side: its plain twin, the pair table and
the layout checks (the kernels themselves run on the card only,
tests/test_torch_cuda.py and chip_smoke.py).

bf16 at head width 64 and 128 goes to ``flash_bwd_sm90.cu``, which rounds P
to bf16 for dV = P^T dO and dS for dQ = dS K and dK = dS^T Q, both computed
in fp32 from the fp32 S and dP (departure (e), ROADMAP queue 3).  Its plain
twin, ``flash_attention_bwd_plain``, does the same; it is held here against
the Pallas backward of ``repro`` in interpret mode, which keeps P and dS in
fp32, on the same bf16 numpy inputs and the same forward output and LSE.

Tolerances: against Pallas, 2e-2 + 2**-6 |ref| (the bf16 tolerance of
tests/test_torch_flash_attention_bwd.py: one bf16 rounding of each
gradient and of each GQA partial the reference rounds) plus the bound of
the rounding of P and dS, ``kernel_bwd.departure_bound`` (2**-8 times
|dS| |K|, |dS|^T |Q| and P^T |dO|, element by element).  Against the fp32-P
plain version: that bound, plus one bf16 step of the result (2**-7 |ref|:
both sides round the gradient) and 1e-3 for values near zero, as
chip_smoke.TOL_BWD_FP32P.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro.kernels.flash_attention.kernel_bwd import flash_attention_bwd as jax_flash_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402

TILE = kernel_bwd.SM90.tile

# (B, Sq, Sk, H, Hkv, d, causal, q_offset): d 64 with GQA rep 4; Sq and Sk
# off the 64- and 128-row tiles with q_offset; not causal at d 128; one
# q row short of a tile with q_offset off the tile; B = 2.
CASES = [
    (1, 128, 128, 8, 2, 64, True, 0),
    (1, 100, 200, 4, 2, 64, True, 100),
    (1, 150, 150, 2, 1, 128, False, 0),
    (1, 17, 130, 4, 4, 128, True, 113),
    (2, 64, 64, 4, 4, 128, True, 0),
]


def _inputs(case, seed=0):
    """The same bf16 q, k, v, dO on both sides, and the reference's forward
    output and LSE (padded to whole blocks there, cut to Sq here)."""
    b, sq, sk, h, hkv, d, causal, q_offset = case
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)]
    tq, tk, tv, tdo = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                       for s in shapes)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv, tdo))
    kw = dict(causal=causal, q_offset=q_offset, block_q=TILE, block_k=TILE, interpret=True)
    out, lse = jax_flash_fwd(jq, jk, jv, return_lse=True, **kw)
    ref = jax_flash_bwd(jq, jk, jv, out, lse, jdo, **kw)
    tout = torch.from_numpy(np.asarray(out, np.float32)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse, np.float32))[:, :sq]
    plain_kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset, block_q=TILE, block_k=TILE)
    return (tq, tk, tv, tout, tlse, tdo), plain_kw, [np.asarray(r, np.float32) for r in ref]


@pytest.mark.parametrize("case", CASES)
def test_plain_twin_matches_pallas(case):
    args, kw, ref = _inputs(case)
    got = kernel_bwd.flash_attention_bwd_plain(*args, **kw)
    bounds = kernel_bwd.departure_bound(*args, **kw)
    for g, r, bound in zip(got, ref, bounds):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - r)
        tol = 2e-2 + 2.0 ** -6 * np.abs(r) + bound.numpy()
        assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("case", CASES)
def test_bf16_p_and_ds_depart_within_their_bound(case):
    """The twin against the fp32-P plain version: every gradient within the
    bound of P's and dS's rounding, and not all equal (the rounding is
    there)."""
    args, kw, _ = _inputs(case, seed=1)
    got = kernel_bwd.flash_attention_bwd_plain(*args, **kw)
    ref = kernel_bwd.flash_attention_bwd_plain(*args, fp32_p=True, **kw)
    bounds = kernel_bwd.departure_bound(*args, **kw)
    for g, r, bound in zip(got, ref, bounds):
        err = (g.float() - r.float()).abs()
        tol = 1e-3 + bound + 2.0 ** -7 * r.float().abs()
        assert bool((err <= tol).all()), float((err / tol).max())
    assert any(not torch.equal(g, r) for g, r in zip(got, ref))


def test_departure_bound_is_the_plain_products_of_magnitudes():
    """``departure_bound`` is 2**-8 times the backward's three products taken
    on |dS|, |K|, |Q|, |dO| and P, computed here densely (no tiles) from the
    fp32-P numerics of one small causal GQA case."""
    case = (1, 40, 40, 2, 1, 64, True, 0)
    args, kw, _ = _inputs(case, seed=2)
    q, k, v, out, do = (t.float()[0].transpose(0, 1) for t in args[:4] + args[5:])  # [H, S, d]
    lse = args[4].view(2, 40)
    c = kw["scale"] * np.log2(np.e)
    s = q @ k.transpose(-1, -2)
    s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp2(c * s - lse[..., None])
    delta = (do * out).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - delta) * kw["scale"]
    # dK and dV sum the GQA group (rep 2, one kv head).
    dense = (ds.abs() @ k.abs(), (ds.abs().transpose(-1, -2) @ q.abs()).sum(0, keepdim=True),
             (p.transpose(-1, -2) @ do.abs()).sum(0, keepdim=True))
    for got, want in zip(kernel_bwd.departure_bound(*args, **kw), dense):
        torch.testing.assert_close(got[0].transpose(0, 1), 2.0 ** -8 * want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,head_dim,pair", [
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
def test_kernel_table(dtype, head_dim, pair):
    """``BWD_KERNELS`` picks the pair from (dtype, head_dim); what it lacks
    raises."""
    if pair is None:
        with pytest.raises(ValueError):
            kernel_bwd.bwd_kernel_for(dtype, head_dim)
        return
    chosen = kernel_bwd.bwd_kernel_for(dtype, head_dim)
    assert chosen.name == pair
    assert chosen.library == ("flash_bwd_sm90" if pair == "sm90" else "flash_bwd")
    assert chosen.entries == tuple(f"{chosen.library}_{k}" for k in ("dq", "dkv"))
    assert kernel_bwd.bwd_tile(dtype, head_dim) == chosen.tile == 64
    assert chosen.rounds == (torch.bfloat16 if pair == "sm90" else None)


def test_launch_counts_sum_by_side():
    """``dq_launch_count`` and ``dkv_launch_count`` are the sums of the two
    pairs' entries in ``launch_counts``."""
    saved = dict(kernel_bwd.launch_counts)
    try:
        kernel_bwd.launch_counts.update(
            flash_bwd_sm90_dq=3, flash_bwd_sm90_dkv=5, flash_bwd_dq=7, flash_bwd_dkv=11)
        assert (kernel_bwd.dq_launch_count, kernel_bwd.dkv_launch_count) == (10, 16)
    finally:
        kernel_bwd.launch_counts.update(saved)
    with pytest.raises(AttributeError):
        kernel_bwd.no_such_count  # noqa: B018


def _bshd(b, s, h, d, dtype=torch.bfloat16):
    return torch.zeros((b, s, h, d), dtype=dtype)


def _misaligned(t):
    """A dense view of ``t``'s shape whose base lies 2 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    start = (-flat.data_ptr() // 2) % 8 + 1
    return flat[start:start + t.numel()].view(t.shape)


@pytest.mark.parametrize("pair,bad,ok", [
    ("sm90", None, True),
    ("sm90", "expanded_do", True),
    ("sm90", "misaligned_do", False),
    ("sm90", "misaligned_out", False),
    ("sm90", "misaligned_k_batch_stride", False),
    ("sm90", "not_dense_q", False),
    ("simt", None, True),
    ("simt", "expanded_do", True),
    ("simt", "misaligned_do", False),
    ("simt", "misaligned_out", False),
    ("simt", "misaligned_k_batch_stride", False),
    ("simt", "not_dense_q", False),
])
def test_layout_checks(pair, bad, ok):
    """What each pair takes, checked on CPU tensors: both need what a TMA
    tensor map (the sm90 pair) and 16-byte cp.async copies (the simt pair)
    can read, 16-byte bases and strides of q, k, v, out and dO; an expanded
    dO (the gradient of ``out.sum()``) is made dense first."""
    kernel = kernel_bwd.SM90 if pair == "sm90" else kernel_bwd.SIMT
    q, k, v, out, do = _bshd(2, 100, 4, 64), _bshd(2, 100, 2, 64), _bshd(2, 100, 2, 64), \
        _bshd(2, 100, 4, 64), _bshd(2, 100, 4, 64)
    if bad == "expanded_do":
        do = torch.ones((), dtype=torch.bfloat16).expand(q.shape)
    elif bad == "misaligned_do":
        do = _misaligned(do)
    elif bad == "misaligned_out":
        out = _misaligned(out)
    elif bad == "misaligned_k_batch_stride":
        k = torch.as_strided(torch.zeros(2 * 100 * 2 * 64 + 4, dtype=torch.bfloat16), (2, 100, 2, 64),
                             (100 * 2 * 64 + 4, 2 * 64, 64, 1))
    elif bad == "not_dense_q":
        q = _bshd(2, 4, 100, 64).transpose(1, 2)
    if not ok:
        with pytest.raises(ValueError):
            kernel_bwd.check_layouts(kernel, q, k, v, out, do)
        return
    dense = kernel_bwd.check_layouts(kernel, q, k, v, out, do)
    assert dense.shape == q.shape and kernel_bwd.is_dense(dense)
    assert torch.equal(dense, do)


@pytest.mark.parametrize("dtype,head_dim,rounds", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, False),
    (torch.float32, 64, False),
])
def test_cpu_path_computes_what_the_card_computes(dtype, head_dim, rounds):
    """On the CPU the wrapper runs the plain twin of the pair the card would
    run, bit for bit: P and dS rounded to bf16 exactly where that pair
    rounds them, and no kernel launched."""
    case = (1, 130, 130, 4, 2, head_dim, True, 0)
    rng = np.random.default_rng(3)
    shapes = [(1, 130, 4, head_dim), (1, 130, 2, head_dim), (1, 130, 2, head_dim), (1, 130, 4, head_dim)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes)
    kw = dict(causal=True, scale=head_dim ** -0.5, q_offset=case[7])
    out, lse = flash_attention_fwd(q, k, v, return_lse=True, block_q=TILE, block_k=TILE, **kw)
    before = dict(kernel_bwd.launch_counts)
    got = kernel_bwd.flash_attention_bwd(q, k, v, out, lse, do, block_q=TILE, block_k=TILE, **kw)
    assert kernel_bwd.launch_counts == before
    twin = kernel_bwd.flash_attention_bwd_plain(q, k, v, out, lse, do, block_q=TILE, block_k=TILE, **kw)
    fp32_p = kernel_bwd.flash_attention_bwd_plain(
        q, k, v, out, lse, do, block_q=TILE, block_k=TILE, fp32_p=True, **kw)
    for g, t, f in zip(got, twin, fp32_p):
        assert g.dtype == dtype
        torch.testing.assert_close(g, t, rtol=0, atol=0)
    assert all(torch.equal(g, f) for g, f in zip(got, fp32_p)) != rounds
