"""repro_torch speculative decoding (``verify_step``, ``rollback_cache``,
``repro_torch.spec`` and ``ServeEngine(spec=...)``) against repro's, on
bridged smoke weights, fp32 on the CPU.

Held here:
  * ``verify_step`` logits and the cache rows it writes equal JAX's from the
    same prefilled cache (olmo-1b, qwen2-vl-7b with M-RoPE, qwen3-moe with
    dropless routing; 1e-4, as tests/test_torch_model.py), and verify row j
    equals the j-th sequential ``decode_step``;
  * under an int8 KV policy the verify rows' int8 payloads are
    byte-identical to sequential decode's writes and to the reference's;
  * rows past the cache's capacity are dropped, the row at ``max_len - 1``
    keeps its valid write, and ``accepted`` is capped as in JAX;
  * ``rollback_cache`` gives every layer its own lengths;
  * the speculative engine's tokens equal the port's vanilla engine's and
    JAX's ``ServeEngine(spec=...)``, with equal spec counters, for dense and
    MoE targets, self-draft (acceptance exactly 1.0), an int8 draft, a
    distinct-arch draft and chunked prefill, through eviction and back-fill;
  * ``compile_counts()`` (verify and the draft's phases included) equals
    the reference's on the same requests and stays unchanged over a second
    wave in the same buckets (the counterpart of tests/test_spec.py's);
  * under a mesh: an in-process 1 x 1 gloo mesh (DTensor params, a placed
    draft cache) gives the tokens and counters of JAX's
    ``ServeEngine(spec=..., mesh=make_debug_mesh(2, 2))``, and the serve
    launcher under ``--mesh 2x2 --spec-draft self`` (and ``--spec-quant
    int8``) in 4 gloo ranks gives sequential decode's tokens;
  * the policy's validation and the launcher's ``--spec-draft``.
Seeds are fixed, so every outcome is deterministic.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.spec import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.spec import make_spec_verify as jax_make_spec_verify  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.quant import parse_quant  # noqa: E402
from repro_torch.serve import Request, SamplingConfig, ServeEngine  # noqa: E402
from repro_torch.spec import SpecConfig, make_spec_verify, resolve_draft_config  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 64
BUCKETS = (8, 16, 32)
# (prompt length, max new tokens): five requests through two slots, so
# slots are evicted and back-filled.
SCHEDULE = [(5, 6), (13, 4), (24, 5), (9, 3), (17, 6)]


def _bridged(arch, quant=None, seed=0):
    jcfg, tcfg = jax_smoke_config(arch, quant), get_smoke_config(arch, quant)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def olmo():
    return _bridged("olmo-1b")


@pytest.fixture(scope="module")
def qwen3_moe():
    return _bridged("qwen3-moe-235b-a22b")


def _close(ours, ref):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref).astype(np.float32), **TOL)


def _prompts(vocab, schedule, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n, _ in schedule]


def _serve(engine, request_cls, prompts, schedule):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=schedule[i][1]))
    return {r.rid: r.output for r in engine.run()}


def _port(tcfg, tparams, prompts, schedule, spec=None, draft_params=None, chunk=None, batch=2):
    engine = ServeEngine(tcfg, tparams, batch_size=batch, max_len=MAX_LEN, prefill_chunk=chunk,
                         prefill_buckets=BUCKETS, spec=spec, draft_params=draft_params, device="cpu")
    return _serve(engine, Request, prompts, schedule), engine


def _jax(jcfg, jparams, prompts, schedule, spec=None, draft_params=None, chunk=None, batch=2):
    engine = JaxServeEngine(jcfg, jparams, batch_size=batch, max_len=MAX_LEN, prefill_chunk=chunk,
                            prefill_buckets=BUCKETS, spec=spec, draft_params=draft_params)
    return _serve(engine, JaxRequest, prompts, schedule), engine


# -- verify_step / rollback_cache against the reference -----------------------


def _prefilled(jcfg, tcfg, jparams, tparams, lengths, capacity=MAX_LEN, seed=1):
    """Both packages' caches after prefilling the same prompts (one per slot,
    right-padded, of ``lengths`` tokens)."""
    rng = np.random.default_rng(seed)
    b, s = len(lengths), max(lengths)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    _, jcache = jm.prefill_step(jparams, jcfg, jnp.asarray(tokens), jm.init_cache(jcfg, b, capacity),
                                jnp.asarray(lengths))
    _, tcache = tm.prefill_step(tparams, tcfg, torch.from_numpy(tokens), tm.init_cache(tcfg, b, capacity, "cpu"),
                                lengths)
    return jcache, tcache


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-7b", "qwen3-moe-235b-a22b"])
def test_verify_step_matches_jax(arch):
    """Logits and every cache leaf after one verify of S = 5 tokens per
    slot, slots at different depths."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    positions = np.array([9, 4], np.int32)
    jcache, tcache = _prefilled(jcfg, tcfg, jparams, tparams, positions)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    ref, jcache = jm.verify_step(jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(positions))
    out, tcache = tm.verify_step(tparams, tcfg, torch.from_numpy(tokens), tcache, torch.from_numpy(positions))
    _close(out, ref)
    for name in tcache._fields:
        _close(getattr(tcache, name), getattr(jcache, name))
    assert tcache.lengths.tolist() == [positions.tolist()] * tcfg.num_layers  # not advanced


@pytest.mark.parametrize("quant", [None, "int8-kv-only", "int8"])
def test_verify_rows_equal_sequential_decode(olmo, quant):
    """Verify row j equals the j-th of S sequential decode steps: the logits
    and the cache rows written.  Under an int8 KV policy the int8 payloads
    are byte-identical to sequential decode's and to the reference's in
    every layer; the fp32 scales are byte-identical to decode's in the
    first layer, whose K/V come from the same embeddings.  Deeper layers'
    K/V come from attention outputs whose fp32 sums run in another order
    (S queries against one), so their scales may differ in the last bits,
    as the reference's do from the port's."""
    if quant is None:
        jcfg, tcfg, jparams, tparams = olmo
    else:
        jcfg, tcfg, jparams, tparams = _bridged("olmo-1b", quant)
    positions = np.array([7, 12], np.int32)
    jcache, tcache = _prefilled(jcfg, tcfg, jparams, tparams, positions)
    seq_cache = type(tcache)(*(leaf.clone() for leaf in tcache))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    seq_logits = []
    for j in range(5):
        lg, seq_cache = tm.decode_step(tparams, tcfg, torch.from_numpy(tokens[:, j:j + 1]), seq_cache,
                                       torch.from_numpy(positions + j))
        seq_logits.append(lg[:, 0])
    out, tcache = tm.verify_step(tparams, tcfg, torch.from_numpy(tokens), tcache, torch.from_numpy(positions))
    np.testing.assert_allclose(out.numpy(), torch.stack(seq_logits, 1).numpy(), rtol=1e-5, atol=1e-5)
    _, jcache = jm.verify_step(jparams, jcfg, jnp.asarray(tokens), jcache, jnp.asarray(positions))
    for name in tcache._fields:
        if name == "lengths":
            continue
        ours, seq, ref = getattr(tcache, name), getattr(seq_cache, name), np.asarray(getattr(jcache, name))
        np.testing.assert_allclose(ours.float().numpy(), seq.float().numpy(), rtol=1e-5, atol=1e-5)
        _close(ours, ref)
        if quant is not None:
            assert torch.equal(ours[0], seq[0]), name
            if ours.dtype == torch.int8:
                assert torch.equal(ours, seq), name
                np.testing.assert_array_equal(ours.numpy(), ref, err_msg=name)


def test_capacity_drops_rows_and_caps_acceptance(olmo):
    """Slot 0 at max_len - 2 with K = 4: rows max_len - 2 and max_len - 1
    are written, the three past capacity are dropped (no row before the
    slot's write span changes, the row at max_len - 1 keeps its valid
    write), and ``accepted`` is capped at 1 although the drafts are the
    target's own greedy tokens.  Everything equals the reference's."""
    jcfg, tcfg, jparams, tparams = olmo
    capacity = 16
    positions = np.array([capacity - 2, 5], np.int32)
    jcache, tcache = _prefilled(jcfg, tcfg, jparams, tparams, positions, capacity=capacity)
    before = type(tcache)(*(leaf.clone() for leaf in tcache))
    # Drafts = sequential greedy decode from the same cache, so that every
    # draft matches and only the cap limits acceptance.
    seq_cache = type(tcache)(*(leaf.clone() for leaf in tcache))
    tok = np.array([[3], [7]], np.int32)
    tokens = [tok[:, 0]]
    for j in range(4):
        lg, seq_cache = tm.decode_step(tparams, tcfg, torch.from_numpy(tok), seq_cache,
                                       torch.from_numpy(positions + j))
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32).numpy()
        tokens.append(tok[:, 0])
    tokens = np.stack(tokens, 1)

    greedy, accepted, tcache = make_spec_verify(tcfg)(
        tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(positions))
    jgreedy, jaccepted, jcache = jax_make_spec_verify(jcfg)(
        jparams, jcache, jnp.asarray(tokens), jnp.asarray(positions))
    assert greedy.tolist() == np.asarray(jgreedy).tolist()
    assert accepted.tolist() == np.asarray(jaccepted).tolist() == [1, 4]
    for name in tcache._fields:
        _close(getattr(tcache, name), getattr(jcache, name))
    assert tcache.lengths.tolist() == [[capacity, 10]] * tcfg.num_layers
    # Slot 0: rows before its span untouched; its last row holds the write
    # of position max_len - 1 (what sequential decode wrote there).
    assert torch.equal(tcache.k[:, 0, :capacity - 2], before.k[:, 0, :capacity - 2])
    assert not torch.equal(tcache.k[:, 0, capacity - 1], before.k[:, 0, capacity - 1])
    np.testing.assert_allclose(tcache.k[:, 0, capacity - 1].numpy(), seq_cache.k[:, 0, capacity - 1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rollback_cache_lengths_are_per_layer(olmo):
    _, tcfg, _, _ = olmo
    cache = tm.rollback_cache(tm.init_cache(tcfg, 3, 8, "cpu"), torch.tensor([5, 2, 7], dtype=torch.int32))
    assert cache.lengths.tolist() == [[5, 2, 7]] * tcfg.num_layers
    prefix = tm.init_cache(tcfg, 1, 4, "cpu")._replace(lengths=torch.full((tcfg.num_layers, 1), 4, dtype=torch.int32))
    cache = tm.insert_cache(cache, prefix, 1)
    cache.lengths[0, 0] = 1  # one layer's slot alone
    assert cache.lengths.tolist() == [[1, 4, 7]] + [[5, 4, 7]] * (tcfg.num_layers - 1)
    with pytest.raises(ValueError, match="KVCache"):
        tm.rollback_cache({"state": torch.zeros(2)}, [1, 1])


def test_verify_step_refuses_recurrent_families():
    with pytest.raises(ValueError, match="KV cache"):
        tm.verify_step({}, get_smoke_config("zamba2-1.2b"), torch.zeros((1, 2), dtype=torch.int32), None, [0])


# -- the speculative engine against vanilla and against JAX -------------------


@pytest.mark.parametrize("arch,lookahead", [("olmo-1b", 1), ("olmo-1b", 4), ("olmo-1b", 7),
                                            ("qwen3-moe-235b-a22b", 4)])
def test_spec_engine_matches_vanilla_and_jax(olmo, qwen3_moe, arch, lookahead):
    jcfg, tcfg, jparams, tparams = olmo if arch == "olmo-1b" else qwen3_moe
    prompts = _prompts(jcfg.vocab_size, SCHEDULE, seed=3)
    vanilla, _ = _port(tcfg, tparams, prompts, SCHEDULE)
    out, engine = _port(tcfg, tparams, prompts, SCHEDULE, spec=SpecConfig(lookahead=lookahead))
    ref, jengine = _jax(jcfg, jparams, prompts, SCHEDULE, spec=JaxSpecConfig(lookahead=lookahead),
                        draft_params=jparams)
    assert out == vanilla == ref
    assert engine.stats == {k: jengine.stats[k] for k in engine.stats}
    assert engine.acceptance_rate() == 1.0  # self-draft: every proposal matches
    assert engine.stats["draft_steps"] == (lookahead + 1) * engine.stats["verify_steps"]
    assert engine.stats["decode_steps"] == 0


def test_spec_int8_draft_lossless(olmo):
    """int8 draft, fp32 target: proposals are rejected, the tokens are still
    the target's greedy ones, and acceptance equals the reference's."""
    jcfg, tcfg, jparams, tparams = olmo
    # SCHEDULE's lengths with about twice the new tokens: enough rounds for
    # the int8 draft to be rejected (46 of 52 proposals accepted).
    schedule = [(5, 12), (13, 10), (24, 12), (9, 8), (17, 12)]
    prompts = _prompts(jcfg.vocab_size, schedule, seed=5)
    vanilla, _ = _port(tcfg, tparams, prompts, schedule)
    out, engine = _port(tcfg, tparams, prompts, schedule, spec=SpecConfig(lookahead=4, draft_quant="int8"))
    ref, jengine = _jax(jcfg, jparams, prompts, schedule,
                        spec=JaxSpecConfig(lookahead=4, draft_quant="int8"), draft_params=jparams)
    assert out == vanilla == ref
    assert type(engine.draft.cache).__name__ == "QuantKVCache"
    assert engine.stats == {k: jengine.stats[k] for k in engine.stats}
    assert engine.acceptance_rate() == jengine.acceptance_rate() < 1.0


def test_spec_distinct_draft_arch_lossless(olmo):
    """yi-9b smoke (vocab 256) drafting for olmo-1b smoke, both bridged."""
    jcfg, tcfg, jparams, tparams = olmo
    spec = SpecConfig(draft_arch="yi-9b", lookahead=3)
    jdraft = jm.init_params(jax_smoke_config("yi-9b"), jax.random.PRNGKey(1))
    tdraft = params_from_jax(jax.tree.map(np.asarray, jdraft), "cpu")
    prompts = _prompts(jcfg.vocab_size, SCHEDULE, seed=2)
    vanilla, _ = _port(tcfg, tparams, prompts, SCHEDULE)
    out, engine = _port(tcfg, tparams, prompts, SCHEDULE, spec=spec, draft_params=tdraft)
    ref, jengine = _jax(jcfg, jparams, prompts, SCHEDULE, spec=JaxSpecConfig(draft_arch="yi-9b", lookahead=3),
                        draft_params=jdraft)
    assert out == vanilla == ref
    assert engine.draft_cfg == resolve_draft_config(spec, tcfg) and engine.draft_cfg.name != tcfg.name
    assert engine.stats == {k: jengine.stats[k] for k in engine.stats}


def test_spec_chunked_prefill_matches_vanilla(olmo):
    """Chunked prefill composes with spec: both caches fill chunk by chunk."""
    jcfg, tcfg, jparams, tparams = olmo
    schedule = [(24, 6), (17, 6), (30, 4)]
    prompts = _prompts(jcfg.vocab_size, schedule, seed=11)
    vanilla, _ = _port(tcfg, tparams, prompts, schedule)
    out, engine = _port(tcfg, tparams, prompts, schedule, spec=SpecConfig(lookahead=3), chunk=8)
    ref, jengine = _jax(jcfg, jparams, prompts, schedule, spec=JaxSpecConfig(lookahead=3),
                        draft_params=jparams, chunk=8)
    assert out == vanilla == ref
    assert engine.stats == {k: jengine.stats[k] for k in engine.stats}


@pytest.mark.parametrize("mode", ["vanilla", "spec"])
def test_eviction_then_longer_backfill(olmo, mode):
    """Three requests through two slots; the back-fill prompt is longer than
    the evicted one (another bucket), so a fresh prefill lands in a dirty
    slot of both caches."""
    jcfg, tcfg, jparams, tparams = olmo
    schedule = [(4, 2), (5, 2), (20, 6)]
    prompts = _prompts(jcfg.vocab_size, schedule, seed=13)
    spec, jspec = (SpecConfig(lookahead=4), JaxSpecConfig(lookahead=4)) if mode == "spec" else (None, None)
    vanilla, _ = _port(tcfg, tparams, prompts, schedule)
    out, engine = _port(tcfg, tparams, prompts, schedule, spec=spec)
    ref, _ = _jax(jcfg, jparams, prompts, schedule, spec=jspec, draft_params=jparams if jspec else None)
    assert out == vanilla == ref
    assert engine.stats["prefill_calls"] == 3


def test_spec_capacity_retirement_matches_jax(olmo):
    """A request that runs into the cache's capacity mid-round: verify drops
    the rows past it, acceptance is capped, and the request retires at
    max_len with the tokens vanilla decode gives, as in JAX."""
    jcfg, tcfg, jparams, tparams = olmo
    schedule = [(30, 60), (6, 10)]
    prompts = _prompts(jcfg.vocab_size, schedule, seed=17)
    vanilla, _ = _port(tcfg, tparams, prompts, schedule)
    out, engine = _port(tcfg, tparams, prompts, schedule, spec=SpecConfig(lookahead=4))
    ref, jengine = _jax(jcfg, jparams, prompts, schedule, spec=JaxSpecConfig(lookahead=4), draft_params=jparams)
    assert out == vanilla == ref
    assert len(out[0]) == MAX_LEN - 30 + 1
    assert engine.stats == {k: jengine.stats[k] for k in engine.stats}


# -- policy validation and the launcher ---------------------------------------


def test_spec_config_validation():
    with pytest.raises(ValueError, match="lookahead"):
        SpecConfig(lookahead=0)
    with pytest.raises(ValueError, match="acceptance"):
        SpecConfig(acceptance="topk")
    assert SpecConfig(draft_quant="int8").draft_quant == parse_quant("int8")  # the flag form is parsed
    olmo_cfg = get_smoke_config("olmo-1b")
    with pytest.raises(ValueError, match="rollback"):
        resolve_draft_config(SpecConfig(), get_smoke_config("zamba2-1.2b"))
    with pytest.raises(ValueError, match="rollback"):
        resolve_draft_config(SpecConfig(draft_arch="zamba2-1.2b"), olmo_cfg)
    with pytest.raises(ValueError, match="vocab"):
        resolve_draft_config(SpecConfig(draft_arch="nemotron-4-15b"), olmo_cfg)


def test_engine_refuses_sampling_and_missing_draft_params(olmo):
    _, tcfg, _, tparams = olmo
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(tcfg, tparams, max_len=MAX_LEN, sampling=SamplingConfig(temperature=0.8, seed=1),
                    spec=SpecConfig(), device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(tcfg, tparams, max_len=MAX_LEN, spec=SpecConfig(draft_arch="yi-9b"), device="cpu")


@pytest.mark.parametrize("extra", [[], ["--spec-quant", "int8", "--chunk", "4"], ["--spec-draft", "yi-9b"]])
def test_launcher_serves_speculatively(monkeypatch, capsys, extra):
    from repro_torch.launch import serve as launcher

    argv = ["serve", "--arch", "olmo-1b", "--device", "cpu", "--requests", "5", "--max-new", "6",
            "--spec-draft", "self", "--check"] + extra
    monkeypatch.setattr("sys.argv", argv)
    launcher.main()
    out = capsys.readouterr().out
    assert "check OK: all 5 outputs match sequential decode" in out
    assert "spec: acceptance" in out
    assert "| compiles {'prefill': " in out and "'draft_generate': 1}" in out
    if not extra:
        assert "spec: acceptance 1.000" in out


# (prompt length, max new tokens), as tests/test_spec.py's compile test.
WAVE1 = [(5, 3), (8, 3), (12, 3), (16, 3)]
WAVE2 = [(7, 4), (3, 2), (13, 5), (9, 3)]


@pytest.mark.parametrize("mode", ["vanilla", "spec"])
def test_compile_counts_equal_reference_and_stable(olmo, mode):
    """Buckets (8, 16): prefill 2, and in spec mode verify 1, draft prefill
    2 and draft generate 1, each the reference's count; a second wave of new
    lengths in the same buckets leaves every count as it was."""
    jcfg, tcfg, jparams, tparams = olmo
    spec, jspec = (SpecConfig(lookahead=3), JaxSpecConfig(lookahead=3)) if mode == "spec" else (None, None)
    ours = ServeEngine(tcfg, tparams, batch_size=2, max_len=MAX_LEN, prefill_buckets=(8, 16), spec=spec,
                       device="cpu")
    ref = JaxServeEngine(jcfg, jparams, batch_size=2, max_len=MAX_LEN, prefill_buckets=(8, 16), spec=jspec,
                         draft_params=jparams if jspec else None)
    waves = [(WAVE1, 1, 0), (WAVE2, 2, 10)]
    counts = None
    for wave, seed, rid0 in waves:
        prompts = _prompts(jcfg.vocab_size, wave, seed=seed)
        ours_out = _serve(ours, Request, prompts, wave)
        assert ours_out == _serve(ref, JaxRequest, prompts, wave) and len(ours_out) == 4
        got = ours.compile_counts()
        assert got == ref.compile_counts()
        assert counts is None or got == counts
        counts = got
    assert counts["prefill"] == 2
    if spec is not None:
        assert counts["verify"] == 1 and counts["draft_generate"] == 1 and counts["draft_prefill"] == 2
    else:
        assert counts["generate"] == 1 and "verify" not in counts


def test_spec_engine_under_a_1x1_gloo_mesh_matches_jax_mesh(olmo):
    """A world-size-1 gloo group and a 1 x 1 mesh: the target's and the
    self-draft's params are DTensors, both caches placed; tokens and
    counters equal JAX's spec engine on a 2 x 2 mesh of CPU devices."""
    import torch.distributed as dist

    from repro.dist.sharding import param_shardings as jax_param_shardings
    from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
    from repro_torch.dist import param_shardings, place
    from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh

    jcfg, tcfg, jparams, tparams = olmo
    prompts = _prompts(jcfg.vocab_size, SCHEDULE, seed=3)
    jmesh = jax_debug_mesh(2, 2)
    jplaced = jax.device_put(jparams, jax_param_shardings(jparams, jcfg, jmesh))
    jengine = JaxServeEngine(jcfg, jplaced, batch_size=2, max_len=MAX_LEN, prefill_buckets=BUCKETS,
                             spec=JaxSpecConfig(lookahead=4), mesh=jmesh)
    ref = _serve(jengine, JaxRequest, prompts, SCHEDULE)
    made = ensure_process_group(1, "cpu")
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        placed = place(tparams, param_shardings(tparams, tcfg, mesh))
        engine = ServeEngine(tcfg, placed, batch_size=2, max_len=MAX_LEN, prefill_buckets=BUCKETS,
                             spec=SpecConfig(lookahead=4), device="cpu", mesh=mesh)
        out = _serve(engine, Request, prompts, SCHEDULE)
        assert engine.draft.mesh is mesh and type(engine.draft.cache.k).__name__ == "DTensor"
    finally:
        if made:
            dist.destroy_process_group()
    assert out == ref
    assert engine.stats == {k: jengine.stats[k] for k in engine.stats}
    assert engine.acceptance_rate() == jengine.acceptance_rate() == 1.0


@pytest.mark.parametrize("draft", [[], ["--spec-quant", "int8"]], ids=["self", "self_int8"])
def test_serve_launcher_mesh_2x2_spec_equals_sequential_decode(tmp_path, draft):
    """``launch.serve --mesh 2x2 --spec-draft self --check`` in 4 gloo ranks:
    the self-draft shares the placed params, its cache is placed as the
    target's; every request's tokens equal unsharded sequential decode's,
    also with the int8 draft (its products with the whole operands' scales)."""
    from test_torch_dist import _torchrun

    out = _torchrun(4, ["-m", "repro_torch.launch.serve", "--arch", "olmo-1b", "--check", "--device", "cpu",
                        "--mesh", "2x2", "--requests", "6", "--spec-draft", "self", *draft], tmp_path)
    assert out.stdout.count("check OK: all 6 outputs match sequential decode") == 4


def test_spec_int8_kv_target_matches_jax():
    """The target under int8-kv-only (verify's int8 KV branch) with a
    self-draft: tokens equal vanilla's and JAX's."""
    jcfg, tcfg, jparams, tparams = _bridged("olmo-1b", "int8-kv-only")
    prompts = _prompts(jcfg.vocab_size, SCHEDULE, seed=7)
    vanilla, _ = _port(tcfg, tparams, prompts, SCHEDULE)
    out, engine = _port(tcfg, tparams, prompts, SCHEDULE, spec=SpecConfig(lookahead=4))
    ref, _ = _jax(jcfg, jparams, prompts, SCHEDULE, spec=JaxSpecConfig(lookahead=4), draft_params=jparams)
    assert out == vanilla == ref
    assert type(engine.cache).__name__ == "QuantKVCache" and engine.acceptance_rate() == 1.0


def test_spec_config_is_hashable_and_frozen():
    spec = SpecConfig(lookahead=3, draft_quant="int8-kv-only")
    assert hash(spec) == hash(SpecConfig(lookahead=3, draft_quant="int8-kv-only"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.lookahead = 5
