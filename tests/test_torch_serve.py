"""repro_torch ServeEngine against repro's on bridged olmo-1b smoke weights
(fp32, CPU).  Greedy tokens must be identical: to the JAX engine's, and to
the port's own sequential single-request decode.  Seeds are fixed, so the
outcome is deterministic."""

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


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    return jcfg, jparams, get_smoke_config(ARCH), tparams, prompts


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
