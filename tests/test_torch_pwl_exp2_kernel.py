"""repro_torch.kernels.pwl_exp2 and the Fig. 12 sweep against the JAX package.

On the CPU ``pwl_exp2_cuda`` takes its plain version; the CUDA kernel is held
to the same plain version bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Tolerances:

* against ``repro.core.pwl_exp2.pwl_exp2`` (jnp): equal bits in float32 and
  bfloat16 — both round the multiply and the add separately;
* against ``pwl_exp2_pallas(interpret=True)``: at most 1 ulp in float32 and
  equal bits in bfloat16 — the Pallas kernel rounds ``slope * x_f +
  intercept`` once, as a fused multiply-add (ROADMAP queue 3);
* ``pwl_error_stats``: equal to the reference's, exactly.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pwl_exp2 import pwl_error_stats as jax_error_stats  # noqa: E402
from repro.core.pwl_exp2 import pwl_exp2 as jax_pwl_exp2  # noqa: E402
from repro.kernels.pwl_exp2.kernel import pwl_exp2_pallas  # noqa: E402
from repro_torch.kernels.pwl_exp2 import kernel as pwl_kernel  # noqa: E402
from repro_torch.kernels.pwl_exp2 import pwl_exp2_cuda  # noqa: E402

# The module, as the package exports the function of its name (as repro.core does).
torch_pwl = importlib.import_module("repro_torch.core.pwl_exp2")

SHAPES = [(8,), (1000, 37), (3, 5, 7), (128, 128)]  # tests/test_kernels.py:92
SEGMENTS = [2, 4, 8, 16, 32, 64]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(shape, seed=0) -> np.ndarray:
    return (-np.abs(np.random.default_rng(seed).standard_normal(shape)) * 8.0).astype(np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    """Bit patterns as signed ints (fp32 -> int32, bf16 -> int16)."""
    return a.view(np.int32) if a.dtype == np.float32 else a.view(np.int16)


def _run_both(x: np.ndarray, jdtype, tdtype, num_segments, fn):
    """(port on the CPU, reference) as numpy arrays of the dtype's bits."""
    xt = torch.from_numpy(x).to(tdtype)
    ours = pwl_exp2_cuda(xt, num_segments=num_segments)
    assert ours.dtype == tdtype and ours.shape == xt.shape
    ref = np.asarray(fn(jnp.asarray(x).astype(jdtype), num_segments))
    if tdtype == torch.bfloat16:
        return ours.view(torch.int16).numpy(), ref.view(np.int16)
    return ours.numpy().view(np.int32), ref.view(np.int32)


@pytest.mark.parametrize("num_segments", SEGMENTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_within_one_ulp_of_the_pallas_kernel(shape, dtype, num_segments):
    """fp32: at most 1 ulp from the Pallas kernel in interpret mode; bf16:
    equal bits."""
    jdtype, tdtype = DTYPES[dtype]
    ours, ref = _run_both(
        _x(shape), jdtype, tdtype, num_segments,
        lambda x, k: pwl_exp2_pallas(x, num_segments=k, interpret=True),
    )
    ulps = np.abs(ours.astype(np.int64) - ref.astype(np.int64))
    assert ulps.max() <= (1 if dtype == "float32" else 0), ulps.max()


@pytest.mark.parametrize("num_segments", SEGMENTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_bit_equal_to_the_jnp_function(shape, dtype, num_segments):
    jdtype, tdtype = DTYPES[dtype]
    ours, ref = _run_both(_x(shape, seed=1), jdtype, tdtype, num_segments, jax_pwl_exp2)
    np.testing.assert_array_equal(ours, ref)


def test_rounding_departs_from_pallas_by_one_ulp():
    """The departure in ROADMAP queue 3: the Pallas kernel's single rounding
    of the multiply-add moves some fp32 results by exactly 1 ulp, never
    more, while the jnp function and the port agree bit for bit."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        -np.abs(rng.standard_normal(3000)) * 8.0,
        np.linspace(-152.0, -118.0, 1000),
    ]).astype(np.float32)
    ours = pwl_exp2_cuda(torch.from_numpy(x)).numpy().view(np.int32).astype(np.int64)
    pallas = np.asarray(pwl_exp2_pallas(jnp.asarray(x), interpret=True)).view(np.int32)
    jnp_ref = np.asarray(jax_pwl_exp2(jnp.asarray(x))).view(np.int32)
    differ = int((ours != pallas).sum())
    assert 100 < differ < len(x) // 4, differ
    assert np.abs(ours - pallas).max() == 1
    np.testing.assert_array_equal(ours, jnp_ref)


def test_fp16_rounds_once_and_keeps_subnormals():
    """fp16 (which the reference does not test): the fp32 result rounded
    once to nearest even, fp16 subnormals kept, as numpy's cast does."""
    x = np.concatenate([_x((4096,)), np.linspace(-26.0, -13.0, 4096, dtype=np.float32)])
    got = pwl_exp2_cuda(torch.from_numpy(x).half()).numpy()
    ref = torch_pwl.pwl_exp2(torch.from_numpy(x.astype(np.float16).astype(np.float32))).numpy()
    np.testing.assert_array_equal(got.view(np.int16), ref.astype(np.float16).view(np.int16))
    assert (np.abs(got[got != 0]) < 2.0 ** -14).sum() > 100  # fp16 subnormal results


def test_empty_and_non_contiguous_inputs():
    assert pwl_exp2_cuda(torch.empty((0, 3))).shape == (0, 3)
    base = torch.from_numpy(_x((64, 48)))
    view = base.t()[::2]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        pwl_exp2_cuda(view).numpy(), torch_pwl.pwl_exp2(view.contiguous()).numpy()
    )


@pytest.mark.parametrize("bad", ["float64", "int32", "complex64", "segments_0", "segments_65", "device"])
def test_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(16)
    kw = {}
    if bad in ("float64", "int32", "complex64"):
        x = x.to(getattr(torch, bad))
    elif bad.startswith("segments"):
        kw["num_segments"] = int(bad.split("_")[1])
    else:
        x = torch.zeros(16, device="meta")
    before = pwl_kernel.launch_count
    with pytest.raises(ValueError):
        pwl_exp2_cuda(x, **kw)
    assert pwl_kernel.launch_count == before


def test_cpu_path_launches_nothing():
    x = torch.from_numpy(_x((300,)))
    before = pwl_kernel.launch_count
    out = pwl_exp2_cuda(x, num_segments=8)
    assert pwl_kernel.launch_count == before
    assert torch.equal(out, torch_pwl.pwl_exp2(x, 8))


@pytest.mark.parametrize("num_segments", [2, 4, 8, 16, 32])
def test_pwl_error_stats_equal_the_reference(num_segments):
    ours = torch_pwl.pwl_error_stats(num_segments)
    assert ours == jax_error_stats(num_segments)
    if num_segments == 8:
        assert f"{ours['mre']:.3e}" == "2.728e-02"  # Fig. 12


@pytest.mark.parametrize("num_segments", SEGMENTS)
def test_fig12_inputs_bit_equal_to_the_jnp_function(num_segments):
    """The tune path's own inputs (every negative normal fp16 value, as
    float32): equal bits to the jnp function."""
    x = torch_pwl.fp16_negative_normals()
    assert x.shape == (30_720,) and x.dtype == np.float32
    ours = pwl_exp2_cuda(torch.from_numpy(x), num_segments=num_segments).numpy()
    ref = np.asarray(jax_pwl_exp2(jnp.asarray(x), num_segments))
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_and_ref_entry_points_equal_the_reference(dtype):
    """``repro_torch.kernels.pwl_exp2.{pwl_exp2, pwl_exp2_reference}``, the
    counterparts of the reference package's exports, are bit-equal on the
    CPU to ``repro.kernels.pwl_exp2.pwl_exp2_reference``."""
    from repro.kernels.pwl_exp2 import pwl_exp2_reference as jax_reference
    from repro_torch.kernels.pwl_exp2 import pwl_exp2, pwl_exp2_reference

    x = -np.random.default_rng(5).uniform(0.0, 30.0, (64, 37)).astype(np.float32)
    want = np.asarray(jax_reference(jnp.asarray(x, dtype), 8).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for fn in (pwl_exp2, lambda t, num_segments: pwl_exp2_reference(t, num_segments)):
        got = fn(tx, num_segments=8).float().numpy()
        np.testing.assert_array_equal(got, want)
