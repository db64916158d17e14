"""repro_torch.dist and the sharded model against repro.dist (the
counterparts of tests/test_distribution.py and of the elastic tests in
tests/test_train_serve.py).

* The partition rules are pure functions of (path, shape, mesh sizes):
  ``param_pspec`` for every arch at (16, 16) and (2, 4), and the ZeRO-1,
  batch and cache specs (the int8 KV cache included) on a 2 x 4 mesh, are
  held to the reference's leaf by leaf, exactly.  The port's meshes live on
  a fake process group made and destroyed in the test.
* The sharded model runs in ``torch.distributed.run`` worker processes on
  gloo (``_dist_worker.py``; the workers import no JAX, rendezvous by
  ``--standalone``): the yi-9b smoke forward on a 2 x 2 mesh against the
  JAX unsharded forward within the reference's 2e-3, and in fp32 against
  the port's single-process forward within 1e-5; the same for qwen3-moe
  smoke at capacity_factor 16 (expert parallelism over model = 2); a
  rescale from 2 x 2 to 4 x 1 and one step there; the train launcher under
  ``--mesh 2x1`` for 2 steps against the single-process losses within 1e-5;
  the serve launcher under ``--mesh 2x2`` against sequential decode.
"""

import contextlib
import dataclasses
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

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.dist import elastic as jel  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim.adamw import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.dist import elastic as tel  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.dist.collectives import P, constrain, placements, set_mesh  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim.adamw import make_optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_dist_worker.py")
ATOL_JAX = 2e-3  # tests/test_distribution.py's sharded-vs-unsharded bound
ATOL_FP32 = 1e-5  # the port sharded against the port unsharded, fp32


@contextlib.contextmanager
def fake_mesh(shape, names=("data", "model")):
    """A torch DeviceMesh of ``shape`` over a fake process group (no data
    moves), destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_process_group(int(np.prod(shape))):
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _jpath(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return "/".join(parts)


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {_jpath(path): tuple(s.spec) for path, s in flat}


def _torch_specs(tree) -> dict:
    out = {}
    tsh.tree_map_with_path(lambda path, s: out.__setitem__(path, tuple(s.spec)), tree)
    return out


def _jax_shapes(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jpath(path): (tuple(x.shape), jnp.dtype(x.dtype).name) for path, x in flat}


def _torch_shapes(tree) -> dict:
    out = {}
    tsh.tree_map_with_path(
        lambda path, x: out.__setitem__(path, (tuple(x.shape), str(x.dtype).replace("torch.", ""))), tree
    )
    return out


def _pad(spec, rank):
    return tuple(spec) + (None,) * (rank - len(spec))


# -- the pure rules ---------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(16, 16), (2, 4)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspec_equals_reference(arch, sizes):
    """Every parameter leaf (the port's tree paths join the reference's, leaf
    for leaf) gets the reference's partition spec."""
    jshapes = _jax_shapes(jm.param_shapes(jax_get_config(arch)))
    tshapes = _torch_shapes(tm.param_shapes(get_config(arch)))
    assert tshapes == jshapes
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for path, (shape, _) in jshapes.items():
        want = _pad(jsh.param_pspec(path, shape, jcfg, *sizes), len(shape))
        assert tuple(tsh.param_pspec(path, shape, tcfg, *sizes)) == want, (path, shape)


def _opt_and_cache(arch, quant=None):
    jcfg, tcfg = jax_get_config(arch, quant), get_config(arch, quant)
    name = "adafactor" if arch in ("arctic-480b", "qwen3-moe-235b-a22b") else "adamw"
    jo = jax.eval_shape(jax_make_optimizer(name, lr=1e-3).init, jm.param_shapes(jcfg))
    to = make_optimizer(name, lr=1e-3).init(tm.param_shapes(tcfg))
    return jcfg, tcfg, jo, to


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_batch_and_cache_shardings_equal_reference(arch):
    """On a 2 x 4 mesh: the ZeRO-1 optimizer-state specs (Adafactor's
    factored stats for the two archs that take it), the batch specs of a
    training batch and of a decode step, and the KV/state cache specs, with
    the int8 KV cache of the transformer families, equal the reference's."""
    jcfg, tcfg, jo, to = _opt_and_cache(arch)
    jmesh = jax_debug_mesh(2, 4)
    with fake_mesh((2, 4)) as mesh:
        assert _torch_specs(tsh.zero1_shardings(to, tcfg, mesh)) == _jax_specs(
            jsh.zero1_shardings(jo, jcfg, jmesh))
        batch = {"tokens": np.zeros((8, 16), np.int32), "labels": np.zeros((8, 16), np.int32),
                 "one": np.zeros((1, 16), np.int32), "pos": np.zeros((), np.int32)}
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        assert _torch_specs(tsh.batch_pspec(tbatch, mesh)) == _jax_specs(jsh.batch_pspec(batch, jmesh))
        if jcfg.family == "encoder":
            return
        quants = [None] + (["int8"] if jcfg.family in ("dense", "moe", "vlm") else [])
        for quant in quants:
            jq, tq = jax_get_config(arch, quant), get_config(arch, quant)
            jc = jax.eval_shape(lambda: jm.init_cache(jq, 4, 64))
            tc = tm.init_cache(tq, 4, 64, device="meta")
            assert _torch_shapes(tc) == _jax_shapes(jc)
            assert _torch_specs(tsh.cache_shardings(tc, tq, mesh)) == _jax_specs(
                jsh.cache_shardings(jc, jq, jmesh)), quant


def test_placements_and_constrain():
    """A spec's DTensor placements (grouped axes shard one dim major to
    minor), and ``constrain`` as the reference's: axes the mesh lacks
    dropped, a dim the axes do not divide left alone, the identity without a
    mesh or for a plain tensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import data_axes, model_axis_size

    with fake_mesh((2, 2, 4), ("pod", "data", "model")) as mesh:
        assert data_axes(mesh) == ("pod", "data") and model_axis_size(mesh) == 4
        assert placements(P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
        x = distribute_tensor(torch.empty(8, 12, 6, device="meta"), mesh, [Replicate()] * 3, src_data_rank=None)
        assert constrain(x, ("pod", "data"), "model") is x  # no ambient mesh
        with set_mesh(mesh):
            y = constrain(x, ("pod", "data", "nope"), "model", "model")
            assert y.placements == (Shard(0), Shard(0), Shard(1))
            z = constrain(x, None, None, "model")  # 6 % 4: left unconstrained
            assert z is x
            plain = torch.zeros(8, 12)
            assert constrain(plain, "data") is plain


# -- elastic rescale --------------------------------------------------------------------


@pytest.mark.parametrize("arch, mesh_shape", [
    ("qwen3-moe-235b-a22b", (2, 3)),  # 128 experts % 3 (the reference's case)
    ("qwen3-moe-235b-a22b", (2, 4)),
    ("qwen2.5-32b", (1, 6)),  # 40 heads % 6
    ("yi-9b", (2, 4)),
    ("nemotron-4-15b", (1, 8)),
    ("olmo-1b", (8, 1)),
    ("hubert-xlarge", (1, 3)),
])
def test_rescale_plan_accepts_and_refuses_as_reference(arch, mesh_shape):
    """``rescale_plan`` accepts the meshes the reference accepts and refuses
    the others with the reference's message; an accepted plan's shardings
    are the reference's."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jmesh = jax_debug_mesh(*mesh_shape)
    try:
        jel._validate(jcfg, jmesh)
        want = None
    except ValueError as e:
        want = str(e)
    with fake_mesh(mesh_shape) as mesh:
        if want is not None:
            with pytest.raises(ValueError) as info:
                tel.rescale_plan(tcfg, {}, {}, mesh, old_devices=8)
            assert str(info.value) == want
            return
        pshapes = tm.param_shapes(tcfg)
        plan = tel.rescale_plan(tcfg, pshapes, {}, mesh, old_devices=8)
        assert plan.new_devices == int(np.prod(mesh_shape)) and plan.old_devices == 8
        jplan = jel.rescale_plan(jcfg, jm.param_shapes(jcfg), {}, jmesh, old_devices=8)
        assert _torch_specs(plan.param_shardings) == _jax_specs(jplan.param_shardings)


# -- the sharded model in gloo processes ------------------------------------------------


def _torchrun(nproc: int, args: list, tmp_path: Path, timeout: int = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}",
           *[str(a) for a in args]]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


def _save_params(path: Path, params) -> None:
    flat = {}

    def one(p, x):
        flat[p] = np.asarray(x)

    tsh.tree_map_with_path(one, jax.tree.map(np.asarray, params))
    np.savez(path, **flat)


def test_sharded_forwards_and_rescale_in_gloo_processes(tmp_path):
    """yi-9b and qwen3-moe (capacity_factor 16) smoke forwards on a 2 x 2
    mesh of gloo ranks, from the reference's weights: within 2e-3 of JAX's
    unsharded forward and 1e-5 of the port's (fp32); a 2 x 2 -> 4 x 1
    rescale and one step there: the loss equals the port's single-process
    loss within 1e-5 and every rank holds the same params."""
    rng = np.random.default_rng(0)
    cases = {}
    for arch in ("yi-9b", "qwen3-moe-235b-a22b"):
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        if jcfg.moe is not None:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=16.0))
            tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=16.0))
        assert tcfg.activation_dtype == torch.float32
        jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
        toks = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
        _save_params(tmp_path / f"{arch}.npz", jp)
        np.save(tmp_path / f"{arch}.tokens.npy", toks)
        jref = np.asarray(jm.forward(jp, jcfg, tokens=jnp.asarray(toks)), np.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        with torch.no_grad():
            tref = tm.forward(tp, tcfg, tokens=torch.from_numpy(toks)).numpy()
        cases[arch] = (jref, tref, tp, tcfg, toks)
    _torchrun(4, [WORKER, "forward", tmp_path, "yi-9b", "qwen3-moe-235b-a22b"], tmp_path)
    for arch, (jref, tref, tp, tcfg, toks) in cases.items():
        out = np.load(tmp_path / f"{arch}.out.npy")
        np.testing.assert_allclose(out, jref, atol=ATOL_JAX, rtol=0)
        np.testing.assert_allclose(out, tref, atol=ATOL_FP32, rtol=0)

    # Rescale: the yi-9b params saved by the 2 x 2 run, resumed on 4 x 1.
    jref, tref, tp, tcfg, toks = cases["yi-9b"]
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    with torch.no_grad():
        want = float(tm.lm_loss(tp, tcfg, batch))
    info = json.loads((tmp_path / "yi-9b.rescale.json").read_text())
    assert info["new_devices"] == 4 and info["old_devices"] == 4
    assert abs(info["loss"] - want) <= ATOL_FP32 * max(1.0, abs(want))
    assert info["params_equal_across_ranks"]
    assert info["psum_mean_of_ranks"] == 1.5  # (0 + 1 + 2 + 3) / 4


def test_train_launcher_mesh_2x1_matches_single_process(tmp_path):
    """``launch.train --smoke --device cpu --mesh 2x1`` under torchrun:
    2 steps, losses within 1e-5 of the single-process launcher's (fp32)."""
    args = ["-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--smoke", "--steps", "2",
            "--batch", "4", "--seq", "32", "--device", "cpu", "--ckpt-every", "100"]
    _torchrun(1, [*args, "--ckpt-dir", tmp_path / "ck1", "--metrics-out", tmp_path / "one.prom"], tmp_path)
    out = _torchrun(2, [*args, "--ckpt-dir", tmp_path / "ck2", "--metrics-out", tmp_path / "two.prom",
                        "--mesh", "2x1"], tmp_path)
    assert "mesh {'data': 2, 'model': 1}" in out.stdout

    def losses(name):
        lines = (tmp_path / f"{name}.prom.jsonl").read_text().splitlines()
        return [json.loads(line)["loss"] for line in lines]

    one, two = losses("one"), losses("two")
    assert len(one) == len(two) == 2
    np.testing.assert_allclose(two, one, atol=ATOL_FP32, rtol=0)


def test_serve_launcher_mesh_2x2_equals_sequential_decode(tmp_path):
    """``launch.serve --mesh 2x2 --check`` under torchrun: the engine with
    DTensor params and a placed cache (batch over "data", KV heads over
    "model", ``insert_cache`` on local shards) gives every request the
    tokens of unsharded sequential decode."""
    out = _torchrun(4, ["-m", "repro_torch.launch.serve", "--arch", "yi-9b", "--check", "--device", "cpu",
                        "--mesh", "2x2", "--requests", "6"], tmp_path)
    assert out.stdout.count("check OK: all 6 outputs match sequential decode") == 4
