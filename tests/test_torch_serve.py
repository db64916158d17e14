"""repro_torch ServeEngine against repro's on bridged olmo-1b smoke weights
(fp32, CPU), and on qwen3-moe-235b-a22b smoke weights (MoE: capacity-bound
prefill, dropless decode) under no quantization and under ``int8``.  Greedy
tokens must be identical: to the JAX engine's, and to the port's own
sequential single-request decode (for MoE with ``capacity_factor = E / k``,
where prefill drops nothing: sequential decode is dropless).
``compile_counts()`` equals the reference's on the same requests and stays
unchanged over a second wave in the same buckets (the counterpart of
tests/test_serve_engine.py's compile test).  Seeds are fixed, so the
outcome is deterministic."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    SamplingConfig,
    ServeEngine,
    sequential_greedy_decode,
)

ARCH = "olmo-1b"
MAX_LEN = 48
MAX_NEW = 6
PROMPT_LENS = (3, 17, 9, 30, 5)  # buckets 16 and 32 (and 48 for 30)


def _model(arch, quant=None):
    jcfg = jax_smoke_config(arch, quant)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    return jcfg, jparams, get_smoke_config(arch, quant), tparams, prompts


@pytest.fixture(scope="module")
def model():
    return _model(ARCH)


@pytest.fixture(scope="module", params=["none", "int8"])
def moe_model(request):
    return _model("qwen3-moe-235b-a22b", request.param)


def _serve(engine, request_cls, prompts, max_new=MAX_NEW):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=max_new))
    return {r.rid: r.output for r in engine.run()}


def _port(model, **kw):
    _, _, cfg, params, prompts = model
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu", **kw)
    return _serve(engine, Request, prompts), engine


@pytest.mark.parametrize("batch_size", [4, 2])
def test_greedy_tokens_equal_jax_engine(model, batch_size):
    jcfg, jparams, _, _, prompts = model
    ref = _serve(JaxServeEngine(jcfg, jparams, batch_size=batch_size, max_len=MAX_LEN),
                 JaxRequest, prompts)
    out, engine = _port(model, batch_size=batch_size)
    assert out == ref
    assert engine.stats["prefill_calls"] == len(prompts)


def test_greedy_tokens_equal_sequential_decode(model):
    _, _, cfg, params, prompts = model
    out, _ = _port(model, batch_size=2)  # 5 requests through 2 slots: back-fill
    for i, p in enumerate(prompts):
        assert out[i] == sequential_greedy_decode(cfg, params, p, MAX_NEW, max_len=MAX_LEN)


def test_chunked_prefill_matches_unchunked(model):
    out, _ = _port(model, batch_size=2)
    chunked, _ = _port(model, batch_size=2, prefill_chunk=4)
    assert chunked == out


def test_capacity_retires_requests(model):
    """A request whose cache slot fills retires at max_len, as in JAX."""
    jcfg, jparams, cfg, params, prompts = model
    long = [prompts[3]]  # 30 tokens + 40 new > MAX_LEN
    ref = _serve(JaxServeEngine(jcfg, jparams, batch_size=1, max_len=MAX_LEN), JaxRequest, long, 40)
    out = _serve(ServeEngine(cfg, params, batch_size=1, max_len=MAX_LEN, device="cpu"),
                 Request, long, 40)
    assert out == ref and len(out[0]) == MAX_LEN - len(long[0]) + 1


def test_sampling_is_seeded(model):
    scfg = SamplingConfig(temperature=0.8, top_k=20, top_p=0.9, seed=7)
    first, _ = _port(model, batch_size=2, sampling=scfg)
    second, _ = _port(model, batch_size=2, sampling=scfg)
    assert first == second


def test_top_k_one_is_greedy(model):
    greedy, _ = _port(model, batch_size=2)
    sampled, _ = _port(model, batch_size=2, sampling=SamplingConfig(temperature=1.0, top_k=1, seed=3))
    assert sampled == greedy


def test_moe_greedy_tokens_equal_jax_engine(moe_model):
    """qwen3-moe smoke through both engines, 5 requests over 4 slots."""
    jcfg, jparams, _, _, prompts = moe_model
    ref = _serve(JaxServeEngine(jcfg, jparams, batch_size=4, max_len=MAX_LEN), JaxRequest, prompts)
    out, _ = _port(moe_model, batch_size=4)
    assert out == ref


def test_moe_greedy_tokens_equal_sequential_decode(moe_model):
    """With capacity_factor = E / k the prefill's capacity is its whole
    token pool, nothing drops, and the engine equals dropless sequential
    decode."""
    _, _, cfg, params, prompts = moe_model
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    engine = ServeEngine(cfg, params, batch_size=2, max_len=MAX_LEN, device="cpu")
    out = _serve(engine, Request, prompts)
    for i, p in enumerate(prompts):
        assert out[i] == sequential_greedy_decode(cfg, params, p, MAX_NEW, max_len=MAX_LEN)


@pytest.mark.parametrize("quant", ["int8", "int8-kv-only"])
def test_int8_chunked_equals_unchunked_and_sequential(quant):
    """olmo-1b under an int8 policy: per-row activation scales and per-token
    KV scales make chunked prefill, unchunked prefill and sequential decode
    write and read the same values, so greedy tokens agree."""
    m = _model(ARCH, quant)
    _, _, cfg, params, prompts = m
    out, engine = _port(m, batch_size=2)
    assert type(engine.cache).__name__ == "QuantKVCache"
    chunked, _ = _port(m, batch_size=2, prefill_chunk=4)
    assert chunked == out
    for i, p in enumerate(prompts):
        assert out[i] == sequential_greedy_decode(cfg, params, p, MAX_NEW, max_len=MAX_LEN)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_launcher_serves_recurrent_archs(monkeypatch, capsys, arch):
    """The serve launcher on the recurrent families' smoke configs: mixed
    prompt lengths through the scan prefill and batched decode, every
    output equal to sequential decode (--check)."""
    from repro_torch.launch import serve as launcher

    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--requests", "4", "--prompt-len", "10",
                                     "--max-new", "4", "--batch", "2", "--max-len", "32", "--check",
                                     "--device", "cpu"])
    launcher.main()
    out = capsys.readouterr().out
    assert "completed 4/4 on cpu" in out and "check OK: all 4 outputs match" in out


# (prompt length, max new tokens), as tests/test_serve_engine.py: the first
# wave touches both buckets at both edges, the second new lengths in them.
WAVE1 = [(5, 3), (8, 3), (12, 3), (16, 3)]
WAVE2 = [(7, 4), (3, 2), (13, 5), (9, 3)]


def _wave(engine, request_cls, vocab, wave, seed, rid0=0):
    rng = np.random.default_rng(seed)
    for i, (n, new) in enumerate(wave):
        engine.submit(request_cls(rid=rid0 + i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                                  max_new_tokens=new))
    return {r.rid: r.output for r in engine.run()}


def test_compile_counts_equal_reference_and_stable(model):
    """Prefill counts the buckets touched (2), insert the prefix shapes (2),
    generate 1, as the reference's jit caches; a second wave of new lengths
    in the same buckets adds nothing; the gauge holds the counts."""
    jcfg, jparams, cfg, params, _ = model
    ours = ServeEngine(cfg, params, batch_size=2, max_len=MAX_LEN, prefill_buckets=(8, 16), device="cpu")
    ref = JaxServeEngine(jcfg, jparams, batch_size=2, max_len=MAX_LEN, prefill_buckets=(8, 16))
    assert _wave(ours, Request, cfg.vocab_size, WAVE1, 1) == _wave(ref, JaxRequest, cfg.vocab_size, WAVE1, 1)
    counts = ours.compile_counts()
    assert counts == ref.compile_counts() == {"prefill": 2, "insert": 2, "generate": 1}
    out = _wave(ours, Request, cfg.vocab_size, WAVE2, 2, rid0=10)
    assert out == _wave(ref, JaxRequest, cfg.vocab_size, WAVE2, 2, rid0=10) and len(out) == 4
    assert ours.compile_counts() == counts == ref.compile_counts()
    gauge = ours.registry.snapshot()["gauges"]["serve_jit_executables"]
    assert {k: int(v) for k, v in gauge.items()} == {f'{{phase="{k}"}}': n for k, n in counts.items()}
