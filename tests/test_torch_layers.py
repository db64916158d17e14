"""repro_torch.models.layers against repro.models.layers, fp32 at 1e-6
(the same numpy inputs; fp32 sums taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
B, S, H, D = 2, 9, 3, 16


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "non_parametric"])
def test_norms(norm_type):
    x = _np((B, S, 64), 0) * 3.0 + 1.0
    params = None
    if norm_type != "non_parametric":
        params = {"scale": _np((64,), 1), "bias": _np((64,), 2)}
        if norm_type == "rmsnorm":
            del params["bias"]
    jp = None if params is None else {k: jnp.asarray(v) for k, v in params.items()}
    tp = None if params is None else {k: torch.from_numpy(v) for k, v in params.items()}
    ref = jl.apply_norm(jnp.asarray(x), jp, norm_type)
    _close(tl.apply_norm(torch.from_numpy(x), tp, norm_type), ref)


def test_rms_norm_without_weight():
    x = _np((B, S, H, D), 3)
    _close(tl.rms_norm(torch.from_numpy(x), None), jl.rms_norm(jnp.asarray(x), None))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    x = _np((B, S, H, D), 4)
    pos = (np.arange(S, dtype=np.int32)[None, :] + np.array([[0], [37]], np.int32))
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta), ref)


def test_mrope():
    x = _np((B, S, H, D), 5)
    pos = np.random.default_rng(6).integers(0, 50, (B, S, 3)).astype(np.int32)
    ref = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2), 1_000_000.0)
    _close(tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 2, 2), 1_000_000.0), ref)


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp(mlp_type):
    x = _np((B, S, 32), 7)
    names = ("gate", "up", "down") if mlp_type == "swiglu" else ("up", "down")
    params = {
        n: _np((48, 32) if n == "down" else (32, 48), 8 + i) / np.float32(np.sqrt(32))
        for i, n in enumerate(names)
    }
    ref = jl.mlp_forward(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, mlp_type)
    ours = tl.mlp_forward(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()}, mlp_type
    )
    _close(ours, ref)
