"""The recurrent families of repro_torch against repro's, on bridged weights:
Mamba2 (``models/ssm.py``), mLSTM and sLSTM (``models/xlstm.py``), and the
hybrid (zamba2-1.2b) and ssm (xlstm-125m) branches of ``models/model.py``
and of the serving engine.

Smoke configs in fp32 on the CPU; the same numpy inputs go to both
packages, and the reference runs as its own tests run it (``jnp``: no
Pallas kernel computes these blocks).  Values and caches are held at 1e-4,
as ``test_torch_model.py``: both sides compute in fp32 and only the order of
the sums differs (the gap seen is ~1e-6).  Decode against forward is held
at the reference's own 5e-3 (``tests/test_models.py``).  Departure (f)
(ROADMAP §3) is pinned at the settings that show it: the reference's
gradient is NaN where a masked exponent overflows, the port's is finite.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.obs import mfu as jax_mfu  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.obs import mfu  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serve import Request, ServeEngine, sequential_greedy_decode  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["zamba2-1.2b", "xlstm-125m"]


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


def _trees_close(ours, ref):
    """Two caches of one structure (dicts of NamedTuples, or one NamedTuple)."""
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys()
        for k in ref:
            _trees_close(ours[k], ref[k])
        return
    assert type(ours).__name__ == type(ref).__name__ and ours._fields == ref._fields
    for name in ref._fields:
        _close(getattr(ours, name), getattr(ref, name))


def _setup(name):
    """``arch`` or ``arch@quant-flag``: both smoke configs and bridged params."""
    arch, _, quant = name.partition("@")
    jcfg, tcfg = jax_smoke_config(arch, quant or None), get_smoke_config(arch, quant or None)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, _bridge(jparams)


@pytest.fixture(scope="module", params=ARCHS + [f"{a}@int8" for a in ARCHS])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module", params=ARCHS)
def cache_setup(request):
    return _setup(request.param)


# -- the pieces --------------------------------------------------------------------


@pytest.fixture(scope="module")
def zamba():
    return jax_smoke_config("zamba2-1.2b"), get_smoke_config("zamba2-1.2b")


@pytest.fixture(scope="module")
def xlstm():
    return jax_smoke_config("xlstm-125m"), get_smoke_config("xlstm-125m")


def test_causal_conv(zamba):
    jcfg, _ = zamba
    _, _, conv_ch = jssm._dims(jcfg)
    rng = np.random.default_rng(0)
    xbc, w, b = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 13, conv_ch), (jcfg.ssm.conv_width, conv_ch), (conv_ch,)))
    ref = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    _close(tssm._causal_conv(*map(torch.from_numpy, (xbc, w, b))), ref)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_on_a_padded_sequence(with_h0):
    """20 steps padded to 32 with zeros (as ``mamba_forward`` pads), two
    chunks of 16, from a zero or a given initial state."""
    rng = np.random.default_rng(1)
    b, s, h, p, n, chunk = 2, 20, 4, 16, 8, 16
    x, B, C = (rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(h)) * dt).astype(np.float32)
    x, dt, a, B, C = (np.pad(t, [(0, 0), (0, 12)] + [(0, 0)] * (t.ndim - 2)) for t in (x, dt, a, B, C))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_h0 else None
    args = (x, dt, a, B, C)
    ref_y, ref_h = jssm._ssd_chunked(*map(jnp.asarray, args), chunk, None if h0 is None else jnp.asarray(h0))
    y, hf = tssm._ssd_chunked(*map(torch.from_numpy, args), chunk, None if h0 is None else torch.from_numpy(h0))
    _close(y, ref_y)
    _close(hf, ref_h)


def test_mamba_forward_and_decode(zamba):
    """The block over 13 tokens (a padded last chunk), then four decode
    steps from a random cache: outputs and the new caches."""
    jcfg, tcfg = zamba
    jp = jssm.mamba_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = _bridge(jp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    _close(tssm.mamba_forward(torch.from_numpy(x), tp, tcfg), jssm.mamba_forward(jnp.asarray(x), jp, jcfg))

    template = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    leaves = [rng.standard_normal(leaf.shape).astype(np.float32) for leaf in template]
    jcache = jssm.MambaCache(*map(jnp.asarray, leaves))
    tcache = tssm.MambaCache(*map(torch.from_numpy, leaves))
    for t in range(4):
        x_t = x[:, t:t + 1]
        ref, jcache = jssm.mamba_decode(jnp.asarray(x_t), jp, jcfg, jcache)
        out, tcache = tssm.mamba_decode(torch.from_numpy(x_t), tp, tcfg, tcache)
        _close(out, ref)
        _trees_close(tcache, jcache)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_block_forward_and_decode(xlstm, block):
    """mLSTM / sLSTM over 9 tokens, then decode steps over the same tokens
    from the initial state: each step's output equals the forward's row."""
    jcfg, tcfg = xlstm
    jmod = {"mlstm": (jxl.mlstm_params, jxl.mlstm_forward, jxl.mlstm_decode, jxl.init_mlstm_state),
            "slstm": (jxl.slstm_params, jxl.slstm_forward, jxl.slstm_decode, jxl.init_slstm_state)}[block]
    tmod = {"mlstm": (txl.mlstm_forward, txl.mlstm_decode, txl.init_mlstm_state),
            "slstm": (txl.slstm_forward, txl.slstm_decode, txl.init_slstm_state)}[block]
    jp = jmod[0](jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = _bridge(jp)
    x = np.random.default_rng(3).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    full = tmod[0](torch.from_numpy(x), tp, tcfg)
    _close(full, jmod[1](jnp.asarray(x), jp, jcfg))

    jstate, tstate = jmod[3](jcfg, 2), tmod[2](tcfg, 2, "cpu")
    for t in range(x.shape[1]):
        x_t = x[:, t:t + 1]
        ref, jstate = jmod[2](jnp.asarray(x_t), jp, jcfg, jstate)
        out, tstate = tmod[1](torch.from_numpy(x_t), tp, tcfg, tstate)
        _close(out, ref)
        _close(out[:, 0], full[:, t].detach())
        _trees_close(tstate, jstate)


# -- departure (f) -------------------------------------------------------------------


def _ssd_case(chunk):
    """b 1, S 256, 2 heads of 8, state 8, dt 0.8 (A_log = 0: a = -dt)."""
    rng = np.random.default_rng(4)
    b, s, h, p, n = 1, 256, 2, 8, 8
    x, B, C, gy = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, s, h, p), (b, s, n), (b, s, n), (b, s, h, p)))
    dt = np.full((b, s, h), 0.8, np.float32)

    def jloss(dt):
        y, _ = jssm._ssd_chunked(jnp.asarray(x), dt, -dt, jnp.asarray(B), jnp.asarray(C), chunk)
        return jnp.sum(y * gy), y

    (_, ref_y), ref_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(dt))
    tdt = torch.from_numpy(dt).requires_grad_()
    y, _ = tssm._ssd_chunked(torch.from_numpy(x), tdt, -tdt, torch.from_numpy(B), torch.from_numpy(C), chunk)
    (g,) = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), tdt)
    return y, np.asarray(ref_y), g, np.asarray(ref_g)


def test_departure_f_masks_before_the_exp():
    """Chunk 128: the reference's dt-gradient is NaN (masked exponents
    reach ~+100 and overflow; 0 * inf in the backward), the port's is
    finite and equals the reference's where that is finite; the values are
    the reference's."""
    y, ref_y, g, ref_g = _ssd_case(128)
    assert np.isnan(ref_g).any()
    assert torch.isfinite(g).all()
    finite = np.isfinite(ref_g)
    np.testing.assert_allclose(g.numpy()[finite], ref_g[finite], **TOL)
    _close(y, ref_y)


def test_departure_f_equals_the_reference_where_it_is_finite():
    """Chunk 16: both gradients finite and equal, values equal."""
    y, ref_y, g, ref_g = _ssd_case(16)
    assert np.isfinite(ref_g).all()
    _close(g, ref_g)
    _close(y, ref_y)


# -- the models ----------------------------------------------------------------------


def _shapes(tree, path=""):
    """{path: (shape, dtype)} of a params tree."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in _shapes(sub, f"{path}/{name}").items()}
    return {path: None if tree is None else (tuple(tree.shape), tree.dtype)}


def test_bridge_keeps_structure_and_dtypes():
    """bf16 models: every leaf keeps its shape and dtype (A_log, D and
    dt_bias stay fp32), and the port's own init gives the same tree."""
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16")
        bridged = _bridge(jm.init_params(jcfg, jax.random.PRNGKey(0)))
        own = tm.init_params(dataclasses.replace(get_smoke_config(arch), dtype="bfloat16"), 0, device="cpu")
        assert _shapes(bridged) == _shapes(own)
        if arch == "zamba2-1.2b":
            mamba = bridged["mamba_layers"]["mamba"]
            assert {mamba[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.float32}
            assert mamba["in_proj"].shape[0] == jcfg.num_layers and mamba["in_proj"].dtype == torch.bfloat16
            assert "shared_attn" in bridged and bridged["shared_attn"]["attn"]["wq"].dim() == 2
        else:
            assert bridged["blocks"]["mlstm"]["wq"].shape[0] == jcfg.num_layers // 2


def _close_up_to_a_flip(ours, ref):
    """Logits [B, S, V] under an int8 policy.  Activations are quantized per
    row; where the two sides' fp32 inputs (equal up to the order of sums,
    ~1e-7 apart) straddle a rounding point, one payload lands one int8 step
    away (a flip), and the recurrence carries it to every later token.  So
    each batch row is held at 1e-4 up to its first token beyond that, at
    most one row may have such a token, and there the gap is at most one
    int8 step of that token's logits (max |ref| / 127).  Seen: xlstm-125m,
    row 1 from token 10, 6.1e-4."""
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    flipped = 0
    for row_ours, row_ref in zip(ours, ref):
        beyond = np.nonzero(~np.isclose(row_ours, row_ref, **TOL).all(axis=-1))[0]
        if beyond.size:
            flipped += 1
            t = beyond[0]
            assert np.abs(row_ours[t] - row_ref[t]).max() <= np.abs(row_ref[t]).max() / 127, t
    assert flipped <= 1, flipped


def test_forward_logits(setup):
    jcfg, tcfg, jparams, tparams = setup
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    ours = tm.forward(tparams, tcfg, tokens=torch.from_numpy(tokens))
    ref = jm.forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    if tcfg.quant is None:
        _close(ours, ref)
    else:
        _close_up_to_a_flip(ours, ref)


def _kv_rows_close(tkv, jkv, lengths):
    """KV leaves of the rows below each slot's length (a frozen slot writes
    its pad token at its length, a row no read reaches), and the lengths."""
    for name in tkv._fields:
        ours, ref = getattr(tkv, name), np.asarray(getattr(jkv, name))
        if name == "lengths":
            _close(ours, ref)
            continue
        for slot, n in enumerate(lengths):
            _close(ours[:, slot, :n].float(), ref[:, slot, :n].astype(np.float32))


def test_prefill_by_scan_then_decode(cache_setup):
    """A right-padded 2-row batch: logits below the lengths, recurrent
    states, KV rows below the lengths; then three decode steps, each slot at
    its own depth."""
    jcfg, tcfg, jparams, tparams = cache_setup
    rng = np.random.default_rng(6)
    b, s, capacity = 2, 12, 16
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    jcache = jm.init_cache(jcfg, b, capacity)
    ref, jcache = jm.prefill_step(jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(lengths))
    tcache = tm.init_cache(tcfg, b, capacity, "cpu")
    out, tcache = tm.prefill_step(tparams, tcfg, torch.from_numpy(tokens), tcache, lengths, chunk_size=4)
    for slot, n in enumerate(lengths):
        _close(out[slot, :n], np.asarray(ref)[slot, :n])

    def check():
        for key in tcache:
            if key == "attn":
                _kv_rows_close(tcache[key], jcache[key], lengths + step)
            else:
                _trees_close(tcache[key], jcache[key])

    step = 0
    check()
    for step in range(1, 4):
        tok = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        pos = lengths + step - 1
        ref, jcache = jm.decode_step(jparams, jcfg, jnp.asarray(tok), jcache, jnp.asarray(pos))
        out, tcache = tm.decode_step(tparams, tcfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos))
        _close(out, ref)
        check()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode logits equal the forward's (the reference's
    test_zamba2/xlstm_decode_matches_forward, at its 5e-3)."""
    cfg = get_smoke_config(arch)
    params = tm.init_params(cfg, 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(3))
    full = tm.forward(params, cfg, tokens=tokens)
    cache = tm.init_cache(cfg, 1, 8, "cpu")
    outs = []
    for i in range(8):
        logits, cache = tm.decode_step(params, cfg, tokens[:, i:i + 1], cache, i)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), rtol=0, atol=5e-3)


def test_insert_cache(setup):
    """A random prefix (every leaf of the family's cache) into slot 1: KV
    rows up to the prefix's capacity, lengths and recurrent states whole."""
    jcfg, tcfg, _, _ = setup
    rng = np.random.default_rng(7)

    def fill(leaf):
        if leaf.dtype == jnp.int32:
            return np.full(leaf.shape, 5, np.int32)
        if leaf.dtype == jnp.int8:
            return rng.integers(-127, 128, leaf.shape).astype(np.int8)
        return rng.standard_normal(leaf.shape).astype(np.float32)

    prefix = jax.tree.map(fill, jm.init_cache(jcfg, 1, 5))
    ref = jm.insert_cache(jm.init_cache(jcfg, 3, 8), jax.tree.map(jnp.asarray, prefix), jnp.asarray(1, jnp.int32))
    tprefix = {k: type(tm.init_cache(tcfg, 1, 5, "cpu")[k])(*map(torch.from_numpy, v)) for k, v in prefix.items()}
    _trees_close(tm.insert_cache(tm.init_cache(tcfg, 3, 8, "cpu"), tprefix, 1), ref)
    with pytest.raises(ValueError):
        tm.insert_cache(tm.init_cache(tcfg, 3, 8, "cpu"), tprefix, 3)  # no such slot
    if jcfg.family == "hybrid":
        with pytest.raises(ValueError):
            tm.insert_cache(tm.init_cache(tcfg, 3, 4, "cpu"), tprefix, 1)  # prefix too long


# The input gates' biases: a shift of every i_raw by the same d moves the
# stabiliser m by d too (m = max(log f + m, i_raw), from -1e30), so i_g, f_g
# and the output do not change.  Their gradient is exactly 0 and both sides
# give fp32 noise (~1e-9): they are held to GRAD_REL of the largest gradient
# of the model, the other leaves to GRAD_REL of their own largest.
INVARIANT = ("blocks/mlstm/bi", "blocks/slstm/bi")
GRAD_REL = 1e-5  # as tests/test_torch_train.py


def test_xlstm_lm_loss_and_grads_match_jax():
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.train.train_step import value_and_grad

    jcfg, tcfg, jparams, tparams = _setup("xlstm-125m")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1  # masked out of the mean
    ref_loss, ref = jax.value_and_grad(jm.lm_loss)(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, ours = value_and_grad(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=GRAD_REL)
    ref = {"/".join(str(p.key) for p in path): np.asarray(g)
           for path, g in jax.tree_util.tree_flatten_with_path(ref)[0]}
    ours = {k: v.numpy() for k, v in _flatten_with_paths(ours).items()}
    assert ours.keys() == ref.keys()
    largest = max(float(np.abs(g).max()) for g in ref.values())
    for key, r in ref.items():
        scale = largest if key in INVARIANT else float(np.abs(r).max())
        assert np.abs(ours[key] - r).max() <= GRAD_REL * scale, key
    for key in INVARIANT:
        assert np.abs(ref[key]).max() <= GRAD_REL * largest


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_grads(arch):
    """Checkpointing each hybrid layer (shared attention included) or each
    block pair changes nothing: the recompute runs the same operations."""
    from repro_torch.train.train_step import value_and_grad

    cfg = get_smoke_config(arch)
    params = tm.init_params(cfg, 4, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(4))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = value_and_grad(cfg, params, batch)
    loss_r, grads_r = value_and_grad(dataclasses.replace(cfg, remat=True), params, batch)
    assert float(loss) == float(loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_verify_and_rollback_refuse_recurrent_state():
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        cache = tm.init_cache(cfg, 1, 4, "cpu")
        with pytest.raises(ValueError, match="recurrent|KV cache"):
            tm.verify_step({}, cfg, torch.zeros((1, 2), dtype=torch.int32), cache, [0])
        with pytest.raises(ValueError, match="recurrent"):
            tm.rollback_cache(cache, [0])


# -- serving ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b@int8-kv-only"])
def test_engine_greedy_equals_jax_engine_and_sequential(arch):
    """The port of tests/test_serve_engine.py::test_hybrid_family_scan_prefill
    for both archs (and zamba2 with its shared block's KV cache in int8):
    prefill teacher-forced per bucket with the pad frozen out of the
    recurrence (prefill_chunk is ignored), slots back-filled; greedy tokens
    equal the JAX engine's and sequential decode's."""
    jcfg, cfg, jparams, params = _setup(arch)
    rng = np.random.default_rng(5)
    spec = [(4, 5), (11, 4), (7, 5)]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n, _ in spec]

    def run(engine, request_cls):
        for i, p in enumerate(prompts):
            engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=spec[i][1]))
        return {r.rid: r.output for r in engine.run()}

    engine = ServeEngine(cfg, params, batch_size=2, max_len=32, prefill_buckets=(8, 16),
                         prefill_chunk=4, device="cpu")
    ours = run(engine, Request)
    if cfg.quant is not None:
        assert type(engine.cache["attn"]).__name__ == "QuantKVCache"
    ref = run(JaxServeEngine(jcfg, jparams, batch_size=2, max_len=32, prefill_buckets=(8, 16)), JaxRequest)
    assert ours == ref
    for i, p in enumerate(prompts):
        assert ours[i] == sequential_greedy_decode(cfg, params, p, spec[i][1], max_len=32)


# -- the reference's FLOP formulas, kept (ROADMAP §3 warnings) -------------------------


def test_mfu_keeps_the_reference_attention_term():
    """zamba2: attention counted over all 38 layers (not its 7
    applications), the shared block's params once; xlstm: an attention term
    though it has no attention.  The port's numbers are the reference's."""
    z, x = get_config("zamba2-1.2b"), get_config("xlstm-125m")
    assert mfu._attn_flops_per_token(z, 100.0) == 4.0 * 100.0 * 64 * 32 * 38
    assert mfu._attn_flops_per_token(x, 100.0) == 4.0 * 100.0 * 192 * 4 * 12
    d, d_inner, n, nheads = 2048, 4096, 64, 64
    mamba = d * (2 * d_inner + 2 * n + nheads) + d_inner * d + 4 * (d_inner + 2 * n)
    shared = 4 * d * 32 * 64 + 3 * d * 8192
    assert z.param_count() == 2 * 32000 * d + 38 * mamba + shared
    for cfg in (z, x):
        jcfg = jax_get_config(cfg.name)
        assert mfu.train_step_flops(cfg, 4, 2048) == jax_mfu.train_step_flops(jcfg, 4, 2048)
        assert mfu.prefill_flops(cfg, 100) == jax_mfu.prefill_flops(jcfg, 100)
        assert mfu.decode_flops(cfg, [16, 200]) == jax_mfu.decode_flops(jcfg, [16, 200])
