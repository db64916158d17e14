"""Tests of the hand-written CUDA kernels that need the card.  They import
no JAX, so they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Each kernel is held against its plain PyTorch version
on the same inputs at the kernel's own tiling (fp32 3e-5 for the forward
and 1e-4 + 1e-5 relative for the backward: the order of fp32 sums, over
more terms in dK and dV; bf16 1e-3 + 2**-7 relative: each output is
rounded to bf16 once, and two fp32 values on either side of a rounding
boundary land one bf16 step apart; LSE 1e-4).  The forward's plain version
is the twin of the kernel that takes the inputs (``kernel.KERNELS``): the
sm90 kernel and its twin both round P to bf16 for PV; against the fp32-P
plain version the sm90 kernel is held to 1e-3 + 2**-8 * (the fp32-P plain
version's output on |v|) + 2**-7 relative, the bound of P's rounding
element by element (chip_smoke.TOL_FP32P).  Likewise the backward
(``kernel_bwd.BWD_KERNELS``): the sm90 pair and its twin both round P and dS
to bf16 as product operands; against the fp32-P plain version the sm90 pair
is held to 1e-3 + ``kernel_bwd.departure_bound`` + 2**-7 relative
(departure (e)).  The PWL exp2 kernel is held
to its plain version bit for bit: both round the multiply and the add
separately and the result once to the output's type.  The decode-attention
kernel is held to its plain version in fp32 before the cast to 2e-6 of the
case's largest output: both widen the same values exactly and sum in fp32,
in another order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.pwl_exp2 import pwl_error_stats  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd  # noqa: E402
from repro_torch.kernels.pwl_exp2 import kernel as pwl_kernel  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serve import Request, ServeEngine, sequential_greedy_decode  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from repro_torch.tune import run_tune  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _qkv(shape_q, shape_kv, device, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.randn(s, generator=gen, device=device).to(dtype)
        for s in (shape_q, shape_kv, shape_kv)
    )


def _fwd_tile(q):
    """The q and k tile of the forward kernel that takes q."""
    return flash_kernel.fwd_tile(q.dtype, q.shape[-1])


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_matches_plain(cuda_device, dtype, exp2_impl):
    q, k, v = _qkv((2, 200, 8, 128), (2, 456, 2, 128), cuda_device, dtype)
    kw = dict(causal=True, scale=128 ** -0.5, q_offset=256, exp2_impl=exp2_impl,
              num_segments=8, return_lse=True)
    before = flash_kernel.launch_count
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launch_count == before + 1
    ref, ref_lse = flash_kernel.flash_attention_fwd_plain(
        q, k, v, block_q=_fwd_tile(q), block_k=_fwd_tile(q), **kw
    )
    fp32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-5 if fp32 else 1e-3,
                               rtol=0 if fp32 else 2.0 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("exp2_impl,segments", [("exact", 8), ("pwl", 4), ("pwl", 8)])
@pytest.mark.parametrize("seq_q", [1, 17, 33, 64, 256])
@pytest.mark.parametrize("dtype,head_dim", [(torch.float32, 128), (torch.float32, 64), (torch.bfloat16, 32)])
def test_flash_fwd_simt_matches_plain(cuda_device, dtype, head_dim, seq_q, exp2_impl, segments):
    """The SIMT kernel against its plain version at its 64-key tile: Sq
    around its 16- and 32-row q tiles, GQA rep 2, q_offset > 0, B = 2, the
    LSE; fp32 at 3e-5, bf16 at one bf16 step, the LSE at 1e-4."""
    q_offset = 37
    q, k, v = _qkv((2, seq_q, 8, head_dim), (2, seq_q + q_offset, 4, head_dim), cuda_device, dtype,
                   seed=seq_q)
    kw = dict(causal=True, scale=head_dim ** -0.5, q_offset=q_offset, exp2_impl=exp2_impl,
              num_segments=segments, return_lse=True)
    before = dict(flash_kernel.launch_counts)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launch_counts == dict(before, simt=before["simt"] + 1)
    tile = flash_kernel.SIMT.tile
    ref, ref_lse = flash_kernel.flash_attention_fwd_plain(q, k, v, block_q=tile, block_k=tile, **kw)
    fp32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-5 if fp32 else 1e-3,
                               rtol=0 if fp32 else 2.0 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seq_q", [33, 256])
def test_flash_fwd_simt_q_tiles_agree(cuda_device, seq_q):
    """Both q tiles of the SIMT kernel against the plain version: rows are
    independent, so the tile moves no result beyond fp32's 3e-5."""
    q, k, v = _qkv((1, seq_q, 16, 128), (1, seq_q, 16, 128), cuda_device, torch.float32, seed=3)
    kw = dict(causal=True, scale=128 ** -0.5, q_offset=0, exp2_impl="pwl", num_segments=8,
              return_lse=True)
    tile = flash_kernel.SIMT.tile
    ref, ref_lse = flash_kernel.flash_attention_fwd_plain(q, k, v, block_q=tile, block_k=tile, **kw)
    for block_q in flash_kernel.SIMT_Q_TILES:
        out, lse = flash_kernel._launch(q, k, v, block_q=block_q, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=3e-5, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


# (B, Sq, Sk, H, Hkv, d, causal, q_offset, exp2, segments, kv capacity)
SM90_CASES = [
    (1, 256, 256, 8, 2, 64, True, 0, "exact", 8, None),
    (2, 1, 17, 8, 2, 64, True, 16, "exact", 8, None),
    (1, 17, 200, 4, 4, 128, True, 183, "pwl", 4, None),
    (1, 200, 1000, 16, 16, 128, True, 800, "exact", 8, None),
    (2, 300, 700, 8, 2, 128, True, 400, "exact", 8, 1024),
    (3, 1000, 1000, 4, 4, 128, True, 0, "pwl", 8, None),
    (2, 200, 1000, 4, 4, 128, False, 0, "exact", 8, None),
    # The main path's shapes: training (with LSE), and a prefill chunk at
    # q_offset 1024 in a 2048-slot cache.
    (4, 2048, 2048, 16, 16, 128, True, 0, "exact", 8, None),
    (1, 512, 1536, 16, 16, 128, True, 1024, "exact", 8, 2048),
]


@pytest.mark.parametrize("case", SM90_CASES)
def test_flash_fwd_sm90_matches_plain(cuda_device, case):
    """The tensor-core kernel against its twin (P rounded to bf16 as it
    rounds it) at one bf16 step, against the fp32-P plain version within
    the bound of that rounding; the LSE against both at 1e-4."""
    b, sq, sk, h, hkv, d, causal, q_offset, exp2_impl, segments, capacity = case
    q, k, v = _qkv((b, sq, h, d), (b, capacity or sk, hkv, d), cuda_device, torch.bfloat16)
    k, v = k[:, :sk], v[:, :sk]  # with a capacity: a prefix of a KV cache
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset, exp2_impl=exp2_impl,
              num_segments=segments, return_lse=True)
    before = dict(flash_kernel.launch_counts)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.launch_counts == dict(before, sm90=before["sm90"] + 1)
    tile = flash_kernel.SM90.tile
    ref, ref_lse = flash_kernel.flash_attention_fwd_plain(q, k, v, block_q=tile, block_k=tile, **kw)
    ref32, ref32_lse = flash_kernel.flash_attention_fwd_plain(
        q, k, v, block_q=tile, block_k=tile, fp32_p=True, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=2.0 ** -7)
    weighted_abs_v = flash_kernel.flash_attention_fwd_plain(
        q, k, v.abs(), block_q=tile, block_k=tile, fp32_p=True, **dict(kw, return_lse=False))
    bound = 1e-3 + 2.0 ** -8 * weighted_abs_v.float() + 2.0 ** -7 * ref32.float().abs()
    assert bool(((out.float() - ref32.float()).abs() <= bound).all())
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref32_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout", "tma_batch_stride", "simt_batch_stride"])
def test_flash_fwd_refuses_what_it_cannot_take(cuda_device, bad):
    d = 48 if bad == "head_dim" else 64
    dtype = {"dtype": torch.float16, "tma_batch_stride": torch.bfloat16}.get(bad, torch.float32)
    q, k, v = _qkv((1, 64, 2, d), (1, 64, 2, d), cuda_device, dtype)
    if bad == "layout":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)  # [B, S, H, d] view of [B, H, S, d]
    if bad in ("tma_batch_stride", "simt_batch_stride"):
        # dense inner dims, a batch stride of 8 (bf16) or 4 (fp32) bytes past 16:
        # neither TMA nor the SIMT kernel's 16-byte cp.async can read it
        pad = 4 if dtype == torch.bfloat16 else 1
        buf = torch.zeros(2 * 64 * 2 * d + pad, device=cuda_device, dtype=dtype)
        q = k = v = torch.as_strided(buf, (2, 64, 2, d), (64 * 2 * d + pad, 2 * d, d, 1))
    before = flash_kernel.launch_count
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_fwd(q, k, v, causal=True)
    assert flash_kernel.launch_count == before


def test_engine_prefill_goes_through_the_kernel(cuda_device):
    """Greedy serving on the card: one launch per layer per prefill, and the
    tokens of sequential decode (fp32 at d 16: the simt kernel)."""
    cfg = get_smoke_config("olmo-1b")
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 19, 40)]
    engine = ServeEngine(cfg, params, batch_size=2, max_len=64, device=cuda_device)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    before = flash_kernel.launch_count
    done = {r.rid: r.output for r in engine.run()}
    assert flash_kernel.launch_count - before == cfg.num_layers * len(prompts)
    for i, p in enumerate(prompts):
        assert done[i] == sequential_greedy_decode(cfg, params, p, 6, max_len=64)


def test_engine_bf16_prefill_takes_only_the_sm90_kernel(cuda_device):
    """The smoke model in bf16 at head width 64: every prefill launch goes to
    the tensor-core kernel, none to the simt one."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), d_model=256, head_dim=64, dtype="bfloat16")
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 130, 40)]
    engine = ServeEngine(cfg, params, batch_size=2, max_len=256, device=cuda_device)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    before = dict(flash_kernel.launch_counts)
    done = engine.run()
    assert len(done) == len(prompts)
    assert flash_kernel.launch_counts == dict(
        sm90=before["sm90"] + cfg.num_layers * len(prompts), simt=before["simt"])


@pytest.mark.parametrize("draft_quant", [None, "int8"])
def test_spec_engine_on_card(cuda_device, draft_quant):
    """Speculative serving on the card (fp32 smoke model, K = 4; the last
    prompt runs into the 64-slot cache): the vanilla engine's tokens, and
    twice its prefill launches (the draft mirrors every prefill)."""
    from repro_torch.spec import SpecConfig

    cfg = get_smoke_config("olmo-1b")
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 19, 40, 58)]
    outputs, launches = [], []
    for spec in (None, SpecConfig(lookahead=4, draft_quant=draft_quant)):
        engine = ServeEngine(cfg, params, batch_size=2, max_len=64, spec=spec, device=cuda_device)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        before = flash_kernel.launch_count
        outputs.append({r.rid: r.output for r in engine.run()})
        launches.append(flash_kernel.launch_count - before)
    assert outputs[0] == outputs[1]
    assert launches[1] == 2 * launches[0] == 2 * cfg.num_layers * len(prompts)
    assert engine.stats["verify_steps"] > 0 and engine.stats["decode_steps"] == 0


def _counts():
    return (flash_kernel.launch_count, kernel_bwd.dq_launch_count, kernel_bwd.dkv_launch_count)


def _bwd_tile(q):
    """The tile of the backward pair that takes q."""
    return kernel_bwd.bwd_tile(q.dtype, q.shape[-1])


def _bwd_tol(dtype):
    return dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("exp2_impl", ["exact", "pwl"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_plain(cuda_device, dtype, exp2_impl):
    """GQA rep 4, ragged Sq != Sk, q_offset > 0; the LSE of an exact or PWL
    forward (the backward's exp2 is exact either way)."""
    q, k, v = _qkv((2, 200, 8, 128), (2, 456, 2, 128), cuda_device, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dtype)
    kw = dict(causal=True, scale=128 ** -0.5, q_offset=256)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, exp2_impl=exp2_impl, return_lse=True, **kw)
    before = _counts()
    got = kernel_bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2] + 1)
    ref = kernel_bwd.flash_attention_bwd_plain(
        q, k, v, out, lse, do, block_q=_bwd_tile(q), block_k=_bwd_tile(q), **kw
    )
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r.float(), **_bwd_tol(dtype))


# (B, Sq, Sk, H, Hkv, d, causal, q_offset, exp2 of the forward)
SM90_BWD_CASES = [
    (1, 256, 256, 8, 2, 64, True, 0, "exact"),
    (2, 100, 200, 4, 2, 64, True, 100, "exact"),
    (1, 17, 300, 8, 2, 64, True, 283, "exact"),
    (1, 300, 812, 16, 16, 128, True, 512, "exact"),
    (3, 200, 200, 4, 4, 128, True, 0, "pwl"),
    (1, 150, 150, 2, 1, 128, False, 0, "exact"),
    # Key tiles past every row's reach (causal, Sk > Sq + q_offset): dK = dV = 0.
    (1, 100, 400, 4, 2, 64, True, 0, "exact"),
    # The main path's training shape.
    (4, 2048, 2048, 16, 16, 128, True, 0, "exact"),
]


@pytest.mark.parametrize("case", SM90_BWD_CASES)
def test_flash_bwd_sm90_matches_plain(cuda_device, case):
    """The tensor-core pair against its twin (P and dS rounded to bf16 as it
    rounds them) at one bf16 step beside twice ``departure_bound`` (a
    rounding that falls on the other side between the two moves P or dS by
    one bf16 ulp, at most 2**-7 of itself), and against the fp32-P plain
    version within the bound of that rounding (departure (e))."""
    b, sq, sk, h, hkv, d, causal, q_offset, exp2_impl = case
    q, k, v = _qkv((b, sq, h, d), (b, sk, hkv, d), cuda_device, torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    kw = dict(causal=causal, scale=d ** -0.5, q_offset=q_offset)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, exp2_impl=exp2_impl, return_lse=True, **kw)
    before = dict(kernel_bwd.launch_counts)
    got = kernel_bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert kernel_bwd.launch_counts == dict(
        before, flash_bwd_sm90_dq=before["flash_bwd_sm90_dq"] + 1,
        flash_bwd_sm90_dkv=before["flash_bwd_sm90_dkv"] + 1)
    tile = kernel_bwd.SM90.tile
    args = (q, k, v, out, lse, do)
    ref = kernel_bwd.flash_attention_bwd_plain(*args, block_q=tile, block_k=tile, **kw)
    ref32 = kernel_bwd.flash_attention_bwd_plain(*args, block_q=tile, block_k=tile, fp32_p=True, **kw)
    bounds = kernel_bwd.departure_bound(*args, block_q=tile, block_k=tile, **kw)
    for g, r, r32, bound in zip(got, ref, ref32, bounds):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
        # One bf16 step, and roundings of P or dS that fall apart between
        # the kernel and the twin (chip_smoke.TOL_BWD_FLIPS).
        twin_tol = 1e-3 + 2.0 ** -7 * r.float().abs() + 2.0 * bound
        assert bool(((g.float() - r.float()).abs() <= twin_tol).all())
        tol = 1e-3 + bound + 2.0 ** -7 * r32.float().abs()
        assert bool(((g.float() - r32.float()).abs() <= tol).all())


def _bwd_args(shape_q, shape_kv, device, dtype, causal, q_offset, exp2_impl, seed=0):
    """q, k, v, the forward's output and LSE (from the kernel), dO; the
    backward's keywords."""
    q, k, v = _qkv(shape_q, shape_kv, device, dtype, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    kw = dict(causal=causal, scale=shape_q[-1] ** -0.5, q_offset=q_offset)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, exp2_impl=exp2_impl, return_lse=True, **kw)
    return (q, k, v, out, lse, do), kw


@pytest.mark.parametrize("tiles", [(32, 32), (16, 16)])
@pytest.mark.parametrize("seq_q", [1, 17, 33, 100])
@pytest.mark.parametrize("dtype,head_dim", [
    (torch.float32, 16), (torch.float32, 32), (torch.float32, 64), (torch.float32, 128),
    (torch.bfloat16, 16), (torch.bfloat16, 32),
])
def test_flash_bwd_simt_matches_plain(cuda_device, dtype, head_dim, seq_q, tiles):
    """The SIMT pair at each of its resident tiles against the plain version
    at the tiles it ran (dQ at (q tile, 64), dK/dV at (64, k tile)): Sq and
    Sk around the tiles, GQA rep 2 (d 16, 64) and 4 (d 32, 128), q_offset
    37, B = 2, the LSE of a PWL forward at Sq 17 and 100, not causal at Sq
    33; fp32 at 1e-4 + 1e-5 relative, bf16 at one bf16 step."""
    kv_heads = 4 if head_dim in (16, 64) else 2
    causal = seq_q != 33
    args, kw = _bwd_args((2, seq_q, 8, head_dim), (2, seq_q + 37, kv_heads, head_dim), cuda_device, dtype,
                         causal, 37 if causal else 0, "pwl" if seq_q in (17, 100) else "exact", seed=seq_q)
    before = dict(kernel_bwd.launch_counts)
    got = kernel_bwd._launch(*args, tiles=tiles, **kw)
    torch.cuda.synchronize()
    assert kernel_bwd.launch_counts == dict(
        before, flash_bwd_dq=before["flash_bwd_dq"] + 1, flash_bwd_dkv=before["flash_bwd_dkv"] + 1)
    streamed = kernel_bwd.SIMT.tile
    ref_dq = kernel_bwd.flash_attention_bwd_plain(*args, block_q=tiles[0], block_k=streamed, **kw)[0]
    ref_dk, ref_dv = kernel_bwd.flash_attention_bwd_plain(*args, block_q=streamed, block_k=tiles[1], **kw)[1:]
    for g, r in zip(got, (ref_dq, ref_dk, ref_dv)):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r.float(), **_bwd_tol(dtype))


def test_flash_bwd_simt_is_deterministic(cuda_device):
    """No atomics: two calls give the same bits (fp32, GQA rep 2, causal,
    both tilings)."""
    args, kw = _bwd_args((2, 300, 8, 128), (2, 300, 4, 128), cuda_device, torch.float32, True, 0, "exact")
    for tiles in ((32, 32), (16, 16)):
        first = kernel_bwd._launch(*args, tiles=tiles, **kw)
        second = kernel_bwd._launch(*args, tiles=tiles, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("bad", ["misaligned_do", "misaligned_out", "k_batch_stride"])
def test_flash_bwd_simt_refuses_misaligned_inputs(cuda_device, bad):
    """fp32 at d 64 (the SIMT pair): a base 4 bytes past a 16-byte boundary,
    or a batch stride that is not whole 16-byte units, which its cp.async
    copies cannot read, raises ValueError; nothing launches."""
    args, kw = _bwd_args((2, 64, 2, 64), (2, 64, 2, 64), cuda_device, torch.float32, True, 0, "exact")
    q, k, v, out, lse, do = args
    misaligned = lambda t: torch.zeros(t.numel() + 4, device=cuda_device)[1:t.numel() + 1].view(t.shape)  # noqa: E731
    if bad == "misaligned_do":
        do = misaligned(do)
    elif bad == "misaligned_out":
        out = misaligned(out)
    else:
        buf = torch.zeros(2 * 64 * 2 * 64 + 1, device=cuda_device)
        k = torch.as_strided(buf, (2, 64, 2, 64), (64 * 2 * 64 + 1, 2 * 64, 64, 1))
    assert kernel_bwd.bwd_kernel_for(q.dtype, 64) is kernel_bwd.SIMT
    before = dict(kernel_bwd.launch_counts)
    with pytest.raises(ValueError):
        kernel_bwd.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert kernel_bwd.launch_counts == before


@pytest.mark.parametrize("dtype,head_dim,pair", [
    (torch.float32, 64, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
])
def test_flash_bwd_launch_counts_by_kernel(cuda_device, dtype, head_dim, pair):
    """Each backward runs the pair ``BWD_KERNELS`` gives it, once each, and
    no other kernel; ``dq_launch_count`` and ``dkv_launch_count`` are the
    sums."""
    q, k, v = _qkv((1, 130, 4, head_dim), (1, 130, 2, head_dim), cuda_device, dtype)
    kw = dict(causal=True, scale=head_dim ** -0.5, q_offset=0)
    out, lse = flash_kernel.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before, sums = dict(kernel_bwd.launch_counts), _counts()
    kernel_bwd.flash_attention_bwd(q, k, v, out, lse, q, **kw)
    torch.cuda.synchronize()
    chosen = kernel_bwd.bwd_kernel_for(dtype, head_dim)
    assert chosen.name == pair
    assert kernel_bwd.launch_counts == {
        e: n + (e in chosen.entries) for e, n in before.items()}
    assert _counts() == (sums[0], sums[1] + 1, sums[2] + 1)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "lse", "misaligned_do"])
def test_flash_bwd_refuses_what_it_cannot_take(cuda_device, bad):
    d = 48 if bad == "head_dim" else 64
    dtype = {"dtype": torch.float16, "misaligned_do": torch.bfloat16}.get(bad, torch.float32)
    q, k, v = _qkv((1, 64, 2, d), (1, 64, 2, d), cuda_device, dtype)
    lse = torch.zeros((2, 64 if bad != "lse" else 128), device=cuda_device)
    do = q
    if bad == "misaligned_do":  # dense, but 2 bytes past a 16-byte boundary (TMA)
        do = torch.zeros(q.numel() + 8, device=cuda_device, dtype=dtype)[1:q.numel() + 1].view(q.shape)
    before = _counts()
    with pytest.raises(ValueError):
        kernel_bwd.flash_attention_bwd(q, k, v, q, lse, do, causal=True)
    assert _counts() == before


def test_autograd_on_the_card_takes_a_non_dense_grad(cuda_device):
    """The gradient of ``out.sum()`` reaches the backward as an expanded
    view; it is made dense and the kernels run once each."""
    q, k, v = (t.requires_grad_() for t in _qkv((1, 130, 4, 64), (1, 130, 2, 64), cuda_device, torch.float32))
    before = _counts()
    out = flash_attention(q, k, v, True)
    got = torch.autograd.grad(out.sum(), (q, k, v))
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    with torch.no_grad():
        o, lse = flash_kernel.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        ref = kernel_bwd.flash_attention_bwd_plain(
            q, k, v, o, lse, torch.ones_like(o), causal=True, scale=64 ** -0.5, q_offset=0,
            block_q=_bwd_tile(q), block_k=_bwd_tile(q),
        )
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **_bwd_tol(torch.float32))


def test_full_width_loss_backward_through_the_kernels(cuda_device):
    """olmo-1b at full width, depth 1, fp32, remat on: the forward kernel
    runs twice (forward and recompute), each backward kernel once, and every
    gradient is within 1e-4 of its leaf's largest |value| of the naive
    path's (the two paths round attention differently in fp32)."""
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=1, dtype="float32")
    params = init_params(cfg, 0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 257), generator=gen, device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = _counts()
    loss, got = value_and_grad(cfg, params, batch)
    assert _counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    ref_loss, ref = value_and_grad(dataclasses.replace(cfg, attention_impl="naive"), params, batch)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


def _pwl_inputs(device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    x = np.concatenate([
        -np.abs(rng.standard_normal(50_001)) * 30.0,
        np.linspace(-152.0, -118.0, 20_001),  # results around the fp32 underflow
        rng.uniform(-1.0, 0.0, 10_000),
        [0.0, -0.0, -1.0, -126.0, -149.0, -1e30, 2.5, -np.inf, np.nan],
    ]).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, with NaN where the other has NaN (NaN payloads aside)."""
    nan = torch.isnan(a.float())
    ints = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(nan, torch.isnan(b.float())) and torch.equal(
        a.view(ints)[~nan], b.view(ints)[~nan])


@pytest.mark.parametrize("num_segments", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_pwl_exp2_kernel_matches_plain(cuda_device, dtype, num_segments):
    """Bit-equal to the plain version on the card; the ragged length takes
    the scalar tail after the 16-byte vectors, and an offset view the
    scalar path alone."""
    x = _pwl_inputs(cuda_device).to(dtype)
    for view in (x, x[1:], x[::3]):
        before = pwl_kernel.launch_count
        out = pwl_kernel.pwl_exp2_cuda(view, num_segments=num_segments)
        torch.cuda.synchronize()
        assert pwl_kernel.launch_count == before + 1
        assert out.dtype == dtype and out.shape == view.shape
        assert _same_bits(out, pwl_kernel.pwl_exp2_plain(view, num_segments))


def test_pwl_exp2_kernel_refuses_what_it_cannot_take(cuda_device):
    before = pwl_kernel.launch_count
    for bad in (dict(x=torch.zeros(8, device=cuda_device, dtype=torch.float64)),
                dict(x=torch.zeros(8, device=cuda_device), num_segments=65)):
        with pytest.raises(ValueError):
            pwl_kernel.pwl_exp2_cuda(**bad)
    assert pwl_kernel.pwl_exp2_cuda(torch.zeros(0, device=cuda_device)).numel() == 0
    assert pwl_kernel.launch_count == before


def test_pwl_error_stats_on_the_card_equal_the_cpu(cuda_device):
    before = pwl_kernel.launch_count
    ours = pwl_error_stats(8, lambda x, k: pwl_kernel.pwl_exp2_cuda(x.cuda(), num_segments=k))
    assert pwl_kernel.launch_count == before + 1
    assert ours == pwl_error_stats(8)
    assert f"{ours['mre']:.3e}" == "2.728e-02"


def test_run_tune_paper_on_the_card(cuda_device):
    report = run_tune("paper", seed=0, paper_check_seq=512, device="cuda")
    assert report["paper_checks_ok"] and report["sim_checks_ok"]
    assert report["mesh_devices"] == torch.cuda.device_count()


# -- int8 products and MoE on the card ------------------------------------------------


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("rows", [4, 17, 300])
def test_int8_products_on_the_card_equal_the_cpu(cuda_device, rows, per_channel):
    """int8_dot and int8_dot_batched through torch._int_mm (fewer than 17
    rows padded) give the CPU's exact int32 accumulators and outputs, bit
    for bit."""
    from repro_torch.quant import int8_dot, int8_dot_batched, quantize

    gen = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, 256), generator=gen).to(torch.bfloat16)
    w = (torch.randn((256, 128), generator=gen) / 16).to(torch.bfloat16)
    xe = torch.randn((3, rows, 256), generator=gen).to(torch.bfloat16)
    we = (torch.randn((3, 256, 64), generator=gen) * torch.tensor([1e-2, 1.0, 1e2])[:, None, None]).to(torch.bfloat16)
    for fn, a, b, experts, calls in ((int8_dot, x, w, False, 1), (int8_dot_batched, xe, we, True, 3)):
        before = quantize.int_mm_calls
        acc, _, _ = quantize.int8_accumulate(a.to(cuda_device), b.to(cuda_device), per_channel, experts)
        assert quantize.int_mm_calls - before == calls
        assert torch.equal(acc.cpu(), quantize.int8_accumulate(a, b, per_channel, experts)[0])
        out = fn(a.to(cuda_device), b.to(cuda_device), per_channel=per_channel)
        assert torch.equal(out.cpu(), fn(a, b, per_channel=per_channel))


@pytest.mark.parametrize("width", [16, 32, 64, 96])
def test_int8_dot_takes_every_row_count_at_small_widths(cuda_device, width):
    """Rows padded to a multiple of 32: cuBLASLt refused 17 rows at
    contraction width 64 (the smoke MoE engine's decode step)."""
    from repro_torch.quant import int8_dot

    gen = torch.Generator().manual_seed(width)
    w = torch.randn((width, 32), generator=gen)
    for rows in range(1, 41):
        x = torch.randn((rows, width), generator=gen)
        assert torch.equal(int8_dot(x.to(cuda_device), w.to(cuda_device)).cpu(), int8_dot(x, w))


def test_int8_product_refuses_a_width_int_mm_cannot_take(cuda_device):
    """Widths that are not multiples of 8 (xlstm's [768, 4] gates, an odd
    contraction) are padded with zeros, not refused: the product equals the
    CPU's bit for bit."""
    from repro_torch.quant import int8_dot, quantize

    gen = torch.Generator().manual_seed(12)
    for (m, k, n) in ((32, 12, 16), (5, 768, 4), (40, 13, 7)):
        x, w = torch.randn((m, k), generator=gen), torch.randn((k, n), generator=gen)
        before = quantize.int_mm_calls
        assert torch.equal(int8_dot(x.to(cuda_device), w.to(cuda_device)).cpu(), int8_dot(x, w))
        assert quantize.int_mm_calls - before == 1


@pytest.mark.parametrize("quant", [None, "int8"])
def test_moe_engine_on_the_card_equals_sequential_decode(cuda_device, quant):
    """qwen3-moe smoke in fp32 with capacity_factor E / k (prefill drops
    nothing): the engine's greedy tokens equal dropless sequential decode."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b", quant)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 19, 40)]
    engine = ServeEngine(cfg, params, batch_size=2, max_len=64, device=cuda_device)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = {r.rid: r.output for r in engine.run()}
    for i, p in enumerate(prompts):
        assert done[i] == sequential_greedy_decode(cfg, params, p, 6, max_len=64)


def test_moe_forward_is_bit_equal_across_calls(cuda_device):
    """The combine sums each token's rows in a fixed order (no atomics)."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), d_model=256, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=32, top_k=8))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = moe.moe_params(gen, cfg, torch.bfloat16)
    x = torch.randn((2, 512, 256), generator=gen, device=cuda_device).to(torch.bfloat16)
    first = moe.moe_forward(x, params, cfg)
    for _ in range(3):
        assert torch.equal(moe.moe_forward(x, params, cfg), first)


def test_device_spans_line_up_with_the_profilers_kernels(cuda_device):
    """Each device span around a known launch sequence starts within 50 us
    of its first kernel's start and ends within 50 us of its last kernel's
    end.  A spin kernel queued ahead of each span keeps the device busy, so
    the span's events wait on the device as the model's do.  The profiler's
    clock goes onto the tracer's through the host range that each span
    opens (``record_function``, the span's name): the tracer's clock read
    right after the span, less the end of that range."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import DEVICE_TID

    x = torch.randn(1024, 1024, device=cuda_device)

    def sequence():
        return torch.relu(x @ x).sum()

    tr, after, n = Tracer(), {}, 4
    for _ in range(n):  # the kernels loaded, the tracer's events made
        with tr.span("warm_up", device=True):
            sequence()
    tr.flush()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            torch.cuda._sleep(10_000_000)  # ~5 ms of device work queued ahead of the span
            with tr.span(f"seq{i}", device=True):
                sequence()
            after[f"seq{i}"] = tr.now_s()
            torch.cuda.synchronize()
        tr.flush()
    spans = {e["name"]: e for e in tr.events if e.get("ph") == "X" and e["tid"] == DEVICE_TID}
    events = list(prof.events())
    ranges = {e.name: e.time_range for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.name in after}
    ops = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in after
                 and not getattr(e, "is_user_annotation", False) and "spin_kernel" not in e.name)
    starts = [ranges[f"seq{i}"].start for i in range(n)] + [float("inf")]
    for i in range(n):
        name = f"seq{i}"
        mine = [(a, b) for a, b in ops if starts[i] <= a < starts[i + 1]]
        assert len(mine) >= 3, name
        offset_us = after[name] * 1e6 - ranges[name].end
        first, last = mine[0][0] + offset_us, max(b for _, b in mine) + offset_us
        span = spans[name]
        assert abs(span["ts"] - first) < 50, (name, span["ts"] - first)
        assert abs(span["ts"] + span["dur"] - last) < 50, (name, span["ts"] + span["dur"] - last)


# -- decode attention (kernels/csrc/decode_attention.cu) ---------------------

# (batch, max_len, kv_heads, rep, S, d, dtype): chat's cache (olmo-1b, 128
# slots of 2048), qwen3-moe's rep 16 at a decode step and a verify of 5
# rows, zamba2's d 64, qwen2-vl's rep 7, yi-9b's rep 8, the fp32 smoke
# models' d 16, hubert's d 80 and d 192.
DECODE_CASES = [
    (128, 2048, 16, 1, 1, 128, torch.bfloat16),
    (8, 2048, 4, 16, 1, 128, torch.bfloat16),
    (8, 2048, 4, 16, 5, 128, torch.bfloat16),
    (16, 1024, 32, 1, 1, 64, torch.bfloat16),
    (4, 500, 4, 7, 1, 128, torch.bfloat16),
    (4, 300, 4, 8, 2, 128, torch.float32),
    (4, 64, 2, 2, 5, 16, torch.float32),
    (4, 300, 16, 1, 3, 80, torch.bfloat16),
    (4, 300, 4, 1, 1, 192, torch.float32),
    (4, 300, 4, 2, 1, 192, torch.bfloat16),
]


def _decode_inputs(case, device, seed=0):
    """Random q and cache, and per-slot lengths that include 0, one row
    short of the cache, the whole cache and past it (a retired slot)."""
    b, max_len, kv_heads, rep, s_new, d, dtype = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s_new, kv_heads * rep, d), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((b, max_len, kv_heads, d), generator=gen, device=device).to(dtype) for _ in range(2))
    lengths = np.random.default_rng(seed).integers(0, max_len + 1, b)
    lengths[:4] = (0, max_len - 1, max_len, max_len + 37)[:b]
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device=device)


def _decode_err(out, ref):
    """Largest |kernel - plain| over 2e-6 of the largest |plain| output of
    the case: both widen the same values exactly and sum in fp32; only the
    order of the sums differs (the online softmax's rescaled partial sums
    and the merge of the splits against the plain version's one pass)."""
    return float((out - ref).abs().max() / (2e-6 * ref.abs().max()))


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(str, c[:6])) + str(c[6])[-4:])
def test_decode_attention_matches_plain(cuda_device, case):
    from repro_torch.kernels.decode_attention import kernel as decode_kernel

    q, k, v, write_pos = _decode_inputs(case, cuda_device)
    scale = case[5] ** -0.5
    before = decode_kernel.launches
    out = decode_kernel.decode_attention_fwd(q, k, v, write_pos, scale)
    torch.cuda.synchronize()
    assert decode_kernel.launches == before + 1
    ref = decode_kernel.decode_attention_plain(q, k, v, write_pos, scale)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _decode_err(out, ref) <= 1.0


def test_decode_attention_takes_a_cache_cut_to_some_kv_heads(cuda_device):
    """A strided view (two of four KV heads, as a mesh island cuts them)
    reads what a dense copy of it reads."""
    from repro_torch.kernels.decode_attention import kernel as decode_kernel

    q, k, v, write_pos = _decode_inputs((4, 300, 4, 2, 2, 128, torch.bfloat16), cuda_device)
    q, k, v = q[:, :, :4], k[:, :, 1:3], v[:, :, 1:3]
    got = decode_kernel.decode_attention_fwd(q, k, v, write_pos, 0.1)
    torch.testing.assert_close(got, decode_kernel.decode_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), write_pos, 0.1), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["fp16", "head_dim", "d_strided", "misaligned", "device"])
def test_decode_attention_refuses_what_it_cannot_take(cuda_device, bad):
    from repro_torch.kernels.decode_attention import kernel as decode_kernel

    q, k, v, write_pos = _decode_inputs((2, 64, 2, 2, 1, 64, torch.bfloat16), cuda_device)
    if bad == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :60], k[..., :60].contiguous(), v[..., :60].contiguous()
    elif bad == "d_strided":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "misaligned":
        flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda_device)
        k = flat[1:].view(k.shape).copy_(k)
    else:
        q = q.cpu()
    before = decode_kernel.launches
    with pytest.raises(ValueError):
        decode_kernel.decode_attention_fwd(q, k, v, write_pos, 0.125)
    assert decode_kernel.launches == before


@pytest.mark.parametrize("s_new", [1, 5])
def test_an_int8_cache_attends_through_the_kernel(cuda_device, monkeypatch, s_new):
    """An int8 KV cache, dequantized to fp32 as the reference does, goes
    through the kernel (one launch a layer call) and gives the plain
    version's output within 2e-6 of the largest, before the cast."""
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.models import attention

    cfg = get_smoke_config("olmo-1b", "int8-kv-only")
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    params = attention.attention_params(gen, cfg, torch.float32)
    x = torch.randn((4, s_new, cfg.d_model), generator=gen, device=cuda_device)
    write_pos = torch.tensor([0, 9, 30, 40], dtype=torch.int32, device=cuda_device)
    positions = write_pos[:, None] + torch.arange(s_new, device=cuda_device, dtype=torch.int32)

    def run():
        cache = attention.init_kv_cache(cfg, 4, 32, torch.float32, cuda_device)
        for payload, scales in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
            payload.copy_(torch.randint(-127, 128, payload.shape, generator=gen, device=cuda_device))
            scales.uniform_(0.001, 0.02, generator=gen)
        before = decode_kernel.launches
        out, _ = attention.verify_attention(x, params, cfg, cache, positions, write_pos)
        return out, decode_kernel.launches - before

    gen.manual_seed(5)
    got, launches = run()
    assert launches == 1
    with monkeypatch.context() as m:
        m.setattr(attention, "decode_attention_fwd", decode_kernel.decode_attention_plain)
        gen.manual_seed(5)
        ref, plain_launches = run()
    assert plain_launches == 0
    assert _decode_err(got, ref) <= 1.0


def test_chat_shaped_decode_through_the_engine_equals_the_plain_path(cuda_device, monkeypatch):
    """Eight decode steps of 128 slots of 2048 (olmo-1b's heads, two layers,
    fp32) through ``ServeEngine``: one kernel launch a layer a step, and the
    greedy tokens of the same engine with the plain version in the kernel's
    place, but where the plain path's top two logits at the first
    difference lie within 1e-3 (fp32 sums in another order move a logit by
    ~1e-6)."""
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.models import attention
    from repro_torch.models.model import forward

    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2, dtype="float32")
    params = init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in rng.integers(1, 1500, 128)]
    steps = 8

    def run():
        engine = ServeEngine(cfg, params, batch_size=128, max_len=2048, device=cuda_device)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=steps + 1))
        before = decode_kernel.launches
        done = {r.rid: r.output for r in engine.run()}
        return done, decode_kernel.launches - before, engine.stats["decode_steps"]

    got, launches, decode_steps = run()
    assert decode_steps == steps and launches == cfg.num_layers * steps
    with monkeypatch.context() as m:
        m.setattr(attention, "decode_attention_fwd", decode_kernel.decode_attention_plain)
        ref, plain_launches, _ = run()
    assert plain_launches == 0
    for i, p in enumerate(prompts):
        if got[i] == ref[i]:
            continue
        t = next(j for j, (a, b) in enumerate(zip(got[i], ref[i])) if a != b)
        context = torch.as_tensor(np.concatenate([p, ref[i][:t]]), device=cuda_device)[None]
        with torch.no_grad():
            top = torch.topk(forward(params, cfg, tokens=context)[0, -1].float(), 2).values
        assert float(top[0] - top[1]) <= 1e-3, (i, t, got[i], ref[i])
