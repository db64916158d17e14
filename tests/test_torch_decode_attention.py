"""The decode-attention wrapper (``repro_torch.kernels.decode_attention``)
on the CPU: its plain version against a direct formulation (each query row
a softmax over exactly the rows it sees, in float64) and, through the layer, against
JAX's ``verify_attention`` and ``decode_attention`` on the same numpy
weights, cache and inputs (fp32, 1e-6: the same products in another order);
an int8 cache's fp32 dequantized rows through the wrapper; the wrapper's
refusals; and the split along the rows.  The kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
MAX_LEN = 24
# Cached lengths of five slots: empty, mid-cache, one row short, full, and
# a retired slot whose length ran past the cache.
LENGTHS = (0, 11, MAX_LEN - 1, MAX_LEN, MAX_LEN + 7)
SHAPES = [(rep, s, d) for rep in (1, 2, 16) for s in (1, 5) for d in (16, 64, 128)]


def _direct(q, k, v, write_pos, scale):
    """Query row j of slot b: a softmax over rows 0 .. min(write_pos + j,
    max_len - 1) of its KV head, nothing masked, in float64."""
    b, s_new, heads, _ = q.shape
    max_len, kv_heads = k.shape[1], k.shape[2]
    rep = heads // kv_heads
    out = torch.empty(q.shape, dtype=torch.float64)
    for i in range(b):
        for j in range(s_new):
            rows = min(int(write_pos[i]) + j, max_len - 1) + 1
            for h in range(heads):
                kk, vv = k[i, :rows, h // rep].double(), v[i, :rows, h // rep].double()
                p = torch.softmax((kk @ q[i, j, h].double()) * scale, dim=0)
                out[i, j, h] = p @ vv
    return out


@pytest.mark.parametrize("rep,s_new,d", SHAPES)
def test_plain_equals_the_direct_formulation(rep, s_new, d):
    rng = np.random.default_rng(rep * 100 + s_new * 10 + d)
    kv_heads = 2
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)) for shape in (
        (len(LENGTHS), s_new, kv_heads * rep, d), (len(LENGTHS), MAX_LEN, kv_heads, d),
        (len(LENGTHS), MAX_LEN, kv_heads, d)))
    write_pos = torch.tensor(LENGTHS, dtype=torch.int32)
    scale = d ** -0.5
    got = decode_kernel.decode_attention_fwd(q, k, v, write_pos, scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    # Against exact sums: fp32 rounding of scores and sums, 1e-6 of the
    # largest output (the plain version read 3.6e-7 of it at most).
    ref = _direct(q, k, v, write_pos, scale)
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-6 * float(ref.abs().max()))


def _layer(rep, s_new, d, seed):
    """Equal configs of both packages (the fp32 smoke olmo-1b with 2 KV
    heads of ``d`` shared by ``rep`` q heads each), numpy weights, a random
    cache at LENGTHS, and x."""
    widths = dict(num_heads=2 * rep, num_kv_heads=2, head_dim=d)
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), **widths)
    tcfg = dataclasses.replace(get_smoke_config("olmo-1b"), **widths)
    rng = np.random.default_rng(seed)
    dm, hq, hkv = jcfg.d_model, jcfg.num_heads * d, jcfg.num_kv_heads * d
    params = {name: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32) for name, shape in (
        ("wq", (dm, hq)), ("wk", (dm, hkv)), ("wv", (dm, hkv)), ("wo", (hq, dm)))}
    cache = [rng.standard_normal((len(LENGTHS), MAX_LEN, 2, d), dtype=np.float32) for _ in range(2)]
    lengths = np.array(LENGTHS, dtype=np.int32)
    x = rng.standard_normal((len(LENGTHS), s_new, dm), dtype=np.float32)
    positions = (lengths[:, None] + np.arange(s_new)[None, :]).astype(np.int32)
    return jcfg, tcfg, params, cache, lengths, x, positions


def _torch_cache(cache, lengths):
    return ta.KVCache(k=torch.tensor(cache[0]), v=torch.tensor(cache[1]), lengths=torch.tensor(lengths))


def _jax_cache(cache, lengths):
    return ja.KVCache(k=jnp.asarray(cache[0]), v=jnp.asarray(cache[1]), lengths=jnp.asarray(lengths))


@pytest.mark.parametrize("rep,s_new,d", SHAPES)
def test_verify_attention_matches_jax(rep, s_new, d):
    """S rows a slot from every length of LENGTHS: rows past the cache are
    dropped writes, and the retired slot sees every row."""
    jcfg, tcfg, params, cache, lengths, x, positions = _layer(rep, s_new, d, seed=rep + s_new + d)
    tparams = {name: torch.tensor(w) for name, w in params.items()}
    jparams = {name: jnp.asarray(w) for name, w in params.items()}
    got, tcache = ta.verify_attention(torch.tensor(x), tparams, tcfg, _torch_cache(cache, lengths),
                                      torch.tensor(positions), torch.tensor(lengths))
    ref, jcache = ja.verify_attention(jnp.asarray(x), jparams, jcfg, _jax_cache(cache, lengths),
                                      jnp.asarray(positions), jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name)), **TOL)


@pytest.mark.parametrize("rep,d", [(rep, d) for rep in (1, 2, 16) for d in (16, 64, 128)])
def test_decode_attention_matches_jax(rep, d):
    jcfg, tcfg, params, cache, lengths, x, positions = _layer(rep, 1, d, seed=7 * rep + d)
    tparams = {name: torch.tensor(w) for name, w in params.items()}
    jparams = {name: jnp.asarray(w) for name, w in params.items()}
    got, tcache = ta.decode_attention(torch.tensor(x), tparams, tcfg, _torch_cache(cache, lengths),
                                      torch.tensor(positions))
    ref, jcache = ja.decode_attention(jnp.asarray(x), jparams, jcfg, _jax_cache(cache, lengths),
                                      jnp.asarray(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for name in tcache._fields:
        np.testing.assert_allclose(getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name)), **TOL)


def test_an_int8_cache_takes_the_dequantize_path(monkeypatch):
    """A ``QuantKVCache`` attends over its rows dequantized to fp32 (the
    reference's dequantize) through the wrapper, with q widened to fp32:
    the kernel on the card, the plain version here."""
    cfg = get_smoke_config("olmo-1b", "int8-kv-only")
    calls = []

    def wrapper(q, k, v, *args):
        calls.append((q.dtype, k.dtype, v.dtype))
        return decode_kernel.decode_attention_fwd(q, k, v, *args)

    monkeypatch.setattr(ta, "decode_attention_fwd", wrapper)
    gen = torch.Generator().manual_seed(0)
    params = ta.attention_params(gen, cfg, torch.bfloat16)
    cache = ta.init_kv_cache(cfg, 2, 8, torch.bfloat16, "cpu")
    assert isinstance(cache, ta.QuantKVCache)
    x = torch.randn((2, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    out, cache = ta.decode_attention(x, params, cfg, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert calls == [(torch.float32,) * 3] and out.shape == x.shape and out.dtype == x.dtype
    assert cache.lengths.tolist() == [1, 1]


def _inputs(dtype=torch.bfloat16, d=128, q_dtype=None):
    q = torch.zeros((2, 1, 4, d), dtype=q_dtype or dtype)
    k = torch.zeros((2, 16, 2, d), dtype=dtype)
    return q, k, k.clone(), torch.zeros(2, dtype=torch.int32)


def _bad_layout():
    q, k, v, wp = _inputs()
    # d strided: [B, L, H, d] viewed from [B, L, d, H].
    k = torch.zeros((2, 16, 128, 2), dtype=torch.bfloat16).transpose(2, 3)
    return q, k, v, wp


@pytest.mark.parametrize("case,inputs", [
    ("fp16 cache", lambda: _inputs(torch.float16)),
    ("q fp32, cache bf16", lambda: _inputs(torch.bfloat16, q_dtype=torch.float32)),
    ("d strided", _bad_layout),
    ("head dim 12", lambda: _inputs(torch.float32, d=12)),
    ("head dim 512", lambda: _inputs(torch.bfloat16, d=512)),
])
def test_the_kernel_refuses_what_it_cannot_take(case, inputs):
    with pytest.raises(ValueError):
        decode_kernel.check_inputs(*inputs())


def test_the_wrapper_refuses_q_and_cache_on_different_devices():
    q, k, v, wp = _inputs(torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        decode_kernel.decode_attention_fwd(q, k.to("meta"), v.to("meta"), wp.to("meta"), 0.1)


def test_the_kernel_takes_a_cache_sliced_to_some_kv_heads():
    """A layer's view of a stacked cache, and one cut to some KV heads (the
    mesh's islands): whole 16-byte strides with d dense."""
    stacked = torch.zeros((2, 3, 16, 4, 64), dtype=torch.bfloat16)
    q = torch.zeros((3, 2, 4, 64), dtype=torch.bfloat16)
    wp = torch.zeros(3, dtype=torch.int32)
    decode_kernel.check_inputs(q, stacked[1], stacked[0], wp)
    decode_kernel.check_inputs(q, stacked[1, :, :, 1:3], stacked[0, :, :, 1:3], wp)


@pytest.mark.parametrize("batch,kv_heads,q_rows,max_len", [
    (128, 16, 1, 2048), (1, 4, 1, 2048), (8, 4, 16, 2048), (8, 4, 80, 2048), (2, 2, 1, 64), (4, 32, 3, 300),
    (1, 1, 1, 40), (256, 8, 1, 32768)])
def test_split_plan_fills_the_card(batch, kv_heads, q_rows, max_len):
    sms = 132
    ctas = batch * kv_heads * -(-q_rows // decode_kernel.Q_ROWS_PER_CTA)
    splits, rows = decode_kernel.split_plan(ctas, max_len, sms)
    assert splits * rows >= max_len > (splits - 1) * rows
    assert min(decode_kernel.MIN_ROWS, max_len) <= rows <= decode_kernel.MAX_ROWS
    # Enough CTAs for the card, unless splits of MIN_ROWS rows cannot give them.
    assert ctas * splits >= decode_kernel.CTAS_PER_SM * sms or rows < 2 * decode_kernel.MIN_ROWS
    if (batch, kv_heads, max_len) == (128, 16, 2048):
        assert (splits, rows) == (4, 512)
    if q_rows == 80:  # qwen3-moe's verify of 5 rows at rep 16: five CTAs a (slot, KV head) already
        assert (splits, rows) == (4, 512)
