"""repro_torch.models.model against repro.models.model on bridged weights.

Smoke configs, fp32 on the CPU: olmo-1b (non-parametric LayerNorm, tied
embeddings), yi-9b (RMSNorm, GQA with rep 2), nemotron-4-15b (squared ReLU,
LayerNorm), qwen2.5-32b (qkv bias) and qwen2-vl-7b (M-RoPE; its forward
takes positions whose three sections differ) through the forward, prefill
and decode; hubert-xlarge (the encoder family: frame embeddings in,
bidirectional attention) through the forward.  The MoE family runs the same
checks: qwen3-moe-235b-a22b (QK-norm, capacity-bound routing in forward and
prefill, dropless in decode) and arctic-480b (the dense residual beside the
experts).  So do the int8 policies (``arch@flag``): olmo-1b under ``int8``
(int8 projections and the int8 KV cache), qwen3-moe under ``int8`` (int8
expert products), arctic under ``int8-per-tensor`` and yi-9b under
``int8-kv-only``.  Logits and caches are held at 1e-4: both sides compute
in fp32, but matmul sums run in another order and the differences pass
through two layers and the LM head (the gap seen is ~1e-6, int8 included:
the int8 payloads come out equal).
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
ARCHS = ["olmo-1b", "yi-9b", "nemotron-4-15b", "qwen2.5-32b", "qwen2-vl-7b",
         "qwen3-moe-235b-a22b", "arctic-480b", "olmo-1b@int8", "qwen3-moe-235b-a22b@int8",
         "arctic-480b@int8-per-tensor", "yi-9b@int8-kv-only"]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch, _, quant = request.param.partition("@")
    jcfg, tcfg = jax_smoke_config(arch, quant or None), get_smoke_config(arch, quant or None)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def _caches_close(tcache, jcache):
    """Every leaf of the two caches (a KVCache, or a QuantKVCache whose int8
    payloads must then be equal), which must be of one type."""
    assert type(tcache).__name__ == type(jcache).__name__
    assert tcache._fields == jcache._fields
    for name in tcache._fields:
        _close(getattr(tcache, name).float(), np.asarray(getattr(jcache, name)).astype(np.float32))


def test_bridge_keeps_structure(setup):
    jcfg, _, jparams, tparams = setup
    assert tparams["layers"]["attn"]["wq"].shape == (
        jcfg.num_layers, jcfg.d_model, jcfg.num_heads * jcfg.resolved_head_dim
    )
    expect_none = jcfg.norm_type == "non_parametric"
    assert (tparams["final_norm"] is None) == expect_none
    assert (tparams["layers"]["attn_norm"] is None) == expect_none
    if jcfg.moe is not None:  # stacked experts [L, E, d, f] and the fp32 router
        moe = tparams["layers"]["moe"]
        assert moe["gate"].shape == (jcfg.num_layers, jcfg.moe.num_experts, jcfg.d_model, jcfg.moe.d_ff_expert)
        assert moe["down"].shape == (jcfg.num_layers, jcfg.moe.num_experts, jcfg.moe.d_ff_expert, jcfg.d_model)
        assert moe["router"].dtype == torch.float32
        assert ("dense_mlp" in tparams["layers"]) == jcfg.moe.dense_residual


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
    _caches_close(tcache, jcache)

    # Three decode steps, each slot at its own depth.
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        pos = lengths + step
        ref, jcache = jm.decode_step(jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pos))
        out, tcache = tm.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos))
        _close(out, ref)
    _caches_close(tcache, jcache)


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
    _caches_close(tcache, jcache)
    assert not tcache.k[:, 0].any()  # the full slot kept its (zero) rows


def test_insert_cache(setup):
    """A random prefix (each leaf of the config's cache type) into slot 1."""
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(2)
    template = jm.init_cache(jcfg, 1, 5)
    prefix = {}
    for name, leaf in zip(template._fields, template):
        if name == "lengths":
            prefix[name] = np.full(leaf.shape, 5, np.int32)
        elif leaf.dtype == jnp.int8:
            prefix[name] = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        else:
            prefix[name] = rng.standard_normal(leaf.shape).astype(np.float32)
    jprefix = type(template)(**{k: jnp.asarray(v) for k, v in prefix.items()})
    ref = jm.insert_cache(jm.init_cache(jcfg, 3, 8), jprefix, jnp.asarray(1, jnp.int32))
    tprefix = type(tm.init_cache(tcfg, 1, 5, "cpu"))(**{k: torch.from_numpy(v) for k, v in prefix.items()})
    out = tm.insert_cache(tm.init_cache(tcfg, 3, 8, "cpu"), tprefix, 1)
    _caches_close(out, ref)
    with pytest.raises(ValueError):
        tm.insert_cache(tm.init_cache(tcfg, 3, 4, "cpu"), tprefix, 1)  # prefix too long
