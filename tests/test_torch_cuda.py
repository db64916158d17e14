"""Tests of the hand-written CUDA kernels that need the card.  They import
no JAX, so they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Each kernel is held against its plain PyTorch version
on the same inputs at the kernel's own tiling (fp32 3e-5 for the forward
and 1e-4 + 1e-5 relative for the backward: the order of fp32 sums, over
more terms in dK and dV; bf16 1e-3 + 2**-7 relative: each output is
rounded to bf16 once, and two fp32 values on either side of a rounding
boundary land one bf16 step apart; LSE 1e-4).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_bwd  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serve import Request, ServeEngine, sequential_greedy_decode  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

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
        q, k, v, block_q=flash_kernel.KERNEL_BLOCK, block_k=flash_kernel.KERNEL_BLOCK, **kw
    )
    fp32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-5 if fp32 else 1e-3,
                               rtol=0 if fp32 else 2.0 ** -7)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout"])
def test_flash_fwd_refuses_what_it_cannot_take(cuda_device, bad):
    d = 48 if bad == "head_dim" else 64
    dtype = torch.float16 if bad == "dtype" else torch.float32
    q, k, v = _qkv((1, 64, 2, d), (1, 64, 2, d), cuda_device, dtype)
    if bad == "layout":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)  # [B, S, H, d] view of [B, H, S, d]
    before = flash_kernel.launch_count
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_fwd(q, k, v, causal=True)
    assert flash_kernel.launch_count == before


def test_engine_prefill_goes_through_the_kernel(cuda_device):
    """Greedy serving on the card: one launch per layer per prefill, and the
    tokens of sequential decode."""
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


def _counts():
    return (flash_kernel.launch_count, kernel_bwd.dq_launch_count, kernel_bwd.dkv_launch_count)


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
        q, k, v, out, lse, do, block_q=flash_kernel.KERNEL_BLOCK, block_k=flash_kernel.KERNEL_BLOCK, **kw
    )
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r.float(), **_bwd_tol(dtype))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "lse"])
def test_flash_bwd_refuses_what_it_cannot_take(cuda_device, bad):
    d = 48 if bad == "head_dim" else 64
    dtype = torch.float16 if bad == "dtype" else torch.float32
    q, k, v = _qkv((1, 64, 2, d), (1, 64, 2, d), cuda_device, dtype)
    lse = torch.zeros((2, 64 if bad != "lse" else 128), device=cuda_device)
    before = _counts()
    with pytest.raises(ValueError):
        kernel_bwd.flash_attention_bwd(q, k, v, q, lse, q, causal=True)
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
            block_q=flash_kernel.KERNEL_BLOCK, block_k=flash_kernel.KERNEL_BLOCK,
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
