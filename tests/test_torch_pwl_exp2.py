"""repro_torch.core.pwl_exp2 against repro.core.pwl_exp2 (same numpy inputs)."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.pwl_exp2  # noqa: E402
import repro_torch.core.pwl_exp2  # noqa: E402

jax_pwl = sys.modules["repro.core.pwl_exp2"]
torch_pwl = sys.modules["repro_torch.core.pwl_exp2"]


def _inputs() -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.concatenate([
        -np.abs(rng.standard_normal(50_000)) * 30.0,
        np.linspace(-152.0, -118.0, 20_001),  # results around the fp32 underflow
        rng.uniform(-1.0, 0.0, 10_000),
        [0.0, -0.0, -1.0, -125.0, -126.0, -127.0, -148.0, -149.0, -1e30, 2.5],
    ]).astype(np.float32)


@pytest.mark.parametrize("num_segments", [4, 8, 16])
def test_pwl_exp2_fp32_bit_equal(num_segments):
    x = _inputs()
    ref = np.asarray(jax_pwl.pwl_exp2(jnp.asarray(x), num_segments))
    out = torch_pwl.pwl_exp2(torch.from_numpy(x), num_segments).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_pwl_exp2_bf16():
    x = _inputs()
    ref = np.asarray(jax_pwl.pwl_exp2(jnp.asarray(x, jnp.bfloat16)), np.float32)
    out = torch_pwl.pwl_exp2(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("num_segments", [4, 8, 16])
def test_tables_equal_reference(num_segments):
    for ours, ref in zip(torch_pwl.segment_table(num_segments), jax_pwl.segment_table(num_segments)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        torch_pwl.packed_coeff_table(num_segments), jax_pwl.packed_coeff_table(num_segments)
    )
