"""``repro_torch.dist.pipelined_apply`` (GPipe over "pod") and
``repro_torch.optim.compressed_pmean`` (the int8 gradient all-reduce)
against repro's, on the CPU.

* One ``torch.distributed.run --standalone`` launch of 4 gloo ranks
  (``_dist_worker.py pipeline,pmean``; the workers import no JAX) runs:
  - ``pipelined_apply`` at 4 stages on a ("pod",) mesh and at 2 stages on
    a ("pod", "data") 2 x 2 mesh, width 16, batch 8, 4 microbatches (the
    case of tests/test_distribution.py's pipeline test), with plain and
    DTensor weights: the forward against JAX's ``pipelined_apply`` on a
    pod mesh of 4 (and 2) CPU devices within the reference's 1e-5, and the
    forward and the gradients (weights and input) against the sequential
    schedule within 1e-5, on every rank;
  - ``compressed_pmean`` over 4 "data" ranks with rank-distinct gradients
    and residuals against the reference's under ``shard_map`` on 4 CPU
    devices: averages within 4 fp32 ulps of the largest |value| (the
    summation order may differ), new residuals bit-equal.
* In process: the three fallbacks to the sequential schedule (no mesh, a
  "pod" axis of another size, a batch the microbatches do not divide) are
  bit-equal to it, on a mesh of a fake process group (no data moves).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.dist.pipeline import pipelined_apply as jax_pipelined_apply  # noqa: E402
from repro.optim.grad_compress import compressed_pmean as jax_compressed_pmean  # noqa: E402
from repro_torch.dist import pipelined_apply, set_mesh  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_dist_worker.py")
ATOL = 1e-5  # tests/test_distribution.py's pipeline bound
WIDTH, BATCH, MICROBATCHES = 16, 8, 4
RANKS = 4
PMEAN_LEAVES = {"w": ((16, 8), np.float32), "b": ((24,), np.float32), "h": ((4, 6), np.float16)}


def _stage(w, x):
    return torch.tanh(x @ w)


def _inputs(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        ws4=(rng.standard_normal((4, WIDTH, WIDTH)) * 0.3).astype(np.float32),
        ws2=(rng.standard_normal((2, WIDTH, WIDTH)) * 0.3).astype(np.float32),
        x=rng.standard_normal((BATCH, WIDTH)).astype(np.float32),
        c=rng.standard_normal((BATCH, WIDTH)).astype(np.float32),
    )


def _pmean_inputs(seed=1) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in PMEAN_LEAVES.items():
        for r in range(RANKS):
            out[f"g/{name}/{r}"] = (rng.standard_normal(shape) * (r + 1)).astype(dtype)
            out[f"r/{name}/{r}"] = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """The 4-rank launch: both modes, one process group."""
    out_dir = tmp_path_factory.mktemp("pipeline")
    np.savez(out_dir / "pipeline.npz", **_inputs())
    np.savez(out_dir / "pmean.npz", **_pmean_inputs())
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={RANKS}",
           str(WORKER), "pipeline,pmean", str(out_dir)]
    out = subprocess.run(cmd, env=env, cwd=out_dir, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out_dir


def _jax_pipeline(ws, x, stages):
    mesh = jax.make_mesh((stages,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(lambda w, a: jax_pipelined_apply(
            lambda wi, h: jnp.tanh(h @ wi), w, a, num_stages=stages, num_microbatches=MICROBATCHES))(ws, x))


@pytest.mark.parametrize("stages", [4, 2])
def test_pipeline_matches_jax_and_sequential(gloo_run, stages):
    """The pipelined forward equals JAX's pipelined forward within 1e-5; on
    every rank, with plain and with DTensor weights, forward and gradients
    equal the sequential schedule's within 1e-5."""
    inputs = _inputs()
    got = np.load(gloo_run / "pipeline.out.npz")[f"out{stages}"]
    want = _jax_pipeline(inputs[f"ws{stages}"], inputs["x"], stages)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    errors = json.loads((gloo_run / "pipeline.json").read_text())
    assert len(errors) == RANKS
    for rank_errors in errors:
        for kind in ("plain", "dtensor"):
            for what, err in rank_errors[f"{kind}{stages}"].items():
                assert err <= ATOL, (kind, stages, what, err)


def test_compressed_pmean_matches_jax(gloo_run):
    """Rank-distinct gradients over 4 "data" ranks: the average within 4 fp32
    ulps of the largest |value| of the reference's, the new residual of
    every rank bit-equal to the reference's."""
    from jax.sharding import NamedSharding

    z = _pmean_inputs()
    names = sorted(PMEAN_LEAVES)
    grads = {n: np.stack([z[f"g/{n}/{r}"] for r in range(RANKS)]) for n in names}
    resid = {n: np.stack([z[f"r/{n}/{r}"] for r in range(RANKS)]) for n in names}
    mesh = jax.make_mesh((RANKS,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))

    def local(g, r):
        avg, new_r = jax_compressed_pmean(jax.tree.map(lambda a: a[0], g), jax.tree.map(lambda a: a[0], r), "data")
        return jax.tree.map(lambda a: a[None], avg), jax.tree.map(lambda a: a[None], new_r)

    # Unjitted, as the port runs: under jit XLA fuses the quantize-dequantize
    # and rounds the residual differently from the eager ops in the last bits.
    with jax.set_mesh(mesh):
        spec = jax.tree.map(lambda _: JP("data"), grads)
        g = jax.device_put(grads, jax.tree.map(lambda _: NamedSharding(mesh, JP("data")), grads))
        r = jax.device_put(resid, jax.tree.map(lambda _: NamedSharding(mesh, JP("data")), resid))
        avg, new_r = jax.shard_map(local, in_specs=(spec, spec), out_specs=(spec, spec))(g, r)
    for rank in range(RANKS):
        ours = np.load(gloo_run / f"pmean.{rank}.npz")
        for n in names:
            want = np.asarray(avg[n][rank])
            ulp = np.spacing(np.float32(np.abs(want).max()))
            assert ours[f"avg/{n}"].dtype == np.float32
            np.testing.assert_allclose(ours[f"avg/{n}"], want, atol=4 * ulp, rtol=0)
            np.testing.assert_array_equal(ours[f"r/{n}"], np.asarray(new_r[n][rank]))


@pytest.mark.parametrize("case", ["no_mesh", "pod_size", "indivisible_batch"])
def test_pipeline_fallbacks_are_the_sequential_schedule(case):
    """Without a mesh, on a "pod" axis whose size is not ``num_stages``, and
    for a batch the microbatches do not divide, ``pipelined_apply`` is the
    sequential schedule, bit for bit (on a fake group nothing moves)."""
    inputs = _inputs()
    ws = torch.from_numpy(inputs["ws4"])
    x = torch.from_numpy(inputs["x"])[: 6 if case == "indivisible_batch" else BATCH]
    want = x
    for i in range(4):
        want = _stage(ws[i], want)
    if case == "no_mesh":
        got = pipelined_apply(_stage, ws, x, num_stages=4, num_microbatches=MICROBATCHES)
    else:
        from torch.distributed.device_mesh import init_device_mesh

        with fake_process_group(2 if case == "pod_size" else 4):
            mesh = init_device_mesh("cpu", (2 if case == "pod_size" else 4,), mesh_dim_names=("pod",))
            with set_mesh(mesh):
                got = pipelined_apply(_stage, ws, x, num_stages=4, num_microbatches=MICROBATCHES)
    assert torch.equal(got, want)
