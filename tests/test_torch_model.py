"""repro_torch.models.model against repro.models.model on bridged weights.

Smoke configs, fp32 on the CPU: olmo-1b (non-parametric LayerNorm, tied
embeddings), yi-9b (RMSNorm, GQA with rep 2), nemotron-4-15b (squared ReLU,
LayerNorm), qwen2.5-32b (qkv bias) and qwen2-vl-7b (M-RoPE; its forward
takes positions whose three sections differ) through the forward, prefill
and decode; hubert-xlarge (the encoder family: frame embeddings in,
bidirectional attention) through the forward.  Logits and caches are held
at 1e-4: both sides compute in fp32, but matmul sums run in another order
and the differences pass through two layers and the LM head.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["olmo-1b", "yi-9b", "nemotron-4-15b", "qwen2.5-32b", "qwen2-vl-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_bridge_keeps_structure(setup):
    jcfg, _, jparams, tparams = setup
    assert tparams["layers"]["attn"]["wq"].shape == (
        jcfg.num_layers, jcfg.d_model, jcfg.num_heads * jcfg.resolved_head_dim
    )
    expect_none = jcfg.norm_type == "non_parametric"
    assert (tparams["final_norm"] is None) == expect_none
    assert (tparams["layers"]["attn_norm"] is None) == expect_none


def test_forward_logits(setup):
    jcfg, tcfg, jparams, tparams = setup
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    kw = {}
    if jcfg.mrope_sections is not None:
        # M-RoPE: temporal, height and width positions, each section its own.
        s = np.arange(21, dtype=np.int32)
        pos = np.stack([s, s // 3 + 2, s % 5], axis=-1)
        kw = dict(positions=np.broadcast_to(pos, (2, 21, 3)).copy())
    ref = jm.forward(jparams, jcfg, tokens=jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in kw.items()})
    out = tm.forward(tparams, tcfg, tokens=torch.from_numpy(tokens), **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(out, ref)


def test_encoder_forward_logits():
    """hubert-xlarge: frame embeddings in, bidirectional attention, logits
    over its cluster labels (the encoder family has no decode cache)."""
    jcfg, tcfg = jax_smoke_config("hubert-xlarge"), get_smoke_config("hubert-xlarge")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    embeds = np.random.default_rng(0).standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    ref = jm.forward(jparams, jcfg, embeds=jnp.asarray(embeds))
    _close(tm.forward(tparams, tcfg, embeds=torch.from_numpy(embeds)), ref)


@pytest.mark.parametrize("chunk_size", [None, 4])
def test_prefill_then_decode(setup, chunk_size):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    b, s, capacity = 2, 12, 16
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)

    jcache = jm.init_cache(jcfg, b, capacity)
    ref, jcache = jm.prefill_step(
        jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(lengths), chunk_size=chunk_size
    )
    tcache = tm.init_cache(tcfg, b, capacity, "cpu")
    out, tcache = tm.prefill_step(
        tparams, tcfg, torch.from_numpy(tokens), tcache, lengths, chunk_size=chunk_size
    )
    _close(out, ref)
    for name in ("k", "v", "lengths"):
        _close(getattr(tcache, name), getattr(jcache, name))

    # Three decode steps, each slot at its own depth.
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        pos = lengths + step
        ref, jcache = jm.decode_step(jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pos))
        out, tcache = tm.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos))
        _close(out, ref)
    for name in ("k", "v", "lengths"):
        _close(getattr(tcache, name), getattr(jcache, name))


def test_decode_at_capacity_drops_the_write(setup):
    """A slot whose length reached max_len writes nothing (mode="drop")."""
    jcfg, tcfg, jparams, tparams = setup
    b, capacity = 2, 4
    jcache = jm.init_cache(jcfg, b, capacity)
    jcache = jcache._replace(lengths=jnp.asarray([[4, 1]] * jcfg.num_layers, jnp.int32))
    tcache = tm.init_cache(tcfg, b, capacity, "cpu")
    tcache = tcache._replace(lengths=torch.tensor([[4, 1]] * tcfg.num_layers, dtype=torch.int32))
    tok = np.array([[3], [5]], np.int32)
    pos = np.array([4, 1], np.int32)
    ref, jcache = jm.decode_step(jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pos))
    out, tcache = tm.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos))
    _close(out, ref)
    for name in ("k", "v", "lengths"):
        _close(getattr(tcache, name), getattr(jcache, name))
    assert not tcache.k[:, 0].any()  # the full slot kept its (zero) rows


def test_insert_cache(setup):
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(2)
    shape = (jcfg.num_layers, 1, 5, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    k, v = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    lengths = np.full((jcfg.num_layers, 1), 5, np.int32)
    jprefix = jm.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    ref = jm.insert_cache(jm.init_cache(jcfg, 3, 8), jprefix, jnp.asarray(1, jnp.int32))
    tprefix = tm.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v), lengths=torch.from_numpy(lengths))
    out = tm.insert_cache(tm.init_cache(tcfg, 3, 8, "cpu"), tprefix, 1)
    for name in ("k", "v", "lengths"):
        _close(getattr(out, name), getattr(ref, name))
    with pytest.raises(ValueError):
        tm.insert_cache(tm.init_cache(tcfg, 3, 4, "cpu"), tprefix, 1)  # prefix too long
