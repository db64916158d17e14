"""Tests of the hand-written CUDA kernels that need the card.  They import
no JAX, so they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Each kernel is held against its plain PyTorch version
on the same inputs at the kernel's own tiling (fp32 3e-5: the order of fp32
sums; bf16 1e-3 + 2**-7 relative: the output is rounded to bf16 once, and
two fp32 values on either side of a rounding boundary land one bf16 step
apart; LSE 1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine, sequential_greedy_decode  # noqa: E402

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
