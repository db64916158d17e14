"""int8 products under a model axis > 1 (gloo ranks) against the unsharded
answer.

The reference's attention and MLP are plain GSPMD, so its int8 products
keep global numerics under a mesh: ``quantize_rows`` and
``_quantize_weight`` reduce their absmax over the whole array and the
int32 ``dot_general`` sums the whole contraction before the fp32 epilogue.
The port's islands run on local shards, and its int8 products take the
same global scales and the same int32 sum by collectives over "model"
(``repro_torch.quant.quantize.Split``):

* forwards in fp32 from the reference's weights, within ``ATOL_FP32`` of
  the port's single-process forward under the same policy and within
  ``ATOL_JAX`` of JAX's unsharded one: yi-9b under ``int8`` on 2 x 2
  (heads and KV heads sharded), yi-9b under ``int8-per-tensor`` on 1 x 4
  (4 heads over 2 KV heads: each KV head shared by two ranks), qwen3-moe
  under ``int8`` on 2 x 2 (capacity_factor 16: nothing dropped);
* each kind of split product bit for bit against ``int8_dot`` on the whole
  operands, and gradients of a split product against the whole one's;
  yi-9b's loss and gradients (remat on) under both policies on 2 x 2 and
  1 x 4 against one process's;
* the serve launcher under ``--mesh 2x2`` with ``--quant int8`` and
  ``int8-per-tensor``: sequential decode's tokens;
* the train launcher under ``--quant int8 --mesh 1x2``: the single-process
  launcher's losses within 1e-5;
* what the port is held to: the reference's jitted ``int8_dot`` on a
  2-device mesh equals its unsharded result within 1e-5 relative.
"""

import json
import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from repro.configs.registry import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.quant import int8_dot as jax_int8_dot  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

from test_torch_dist import ATOL_FP32, ATOL_JAX, WORKER, _save_params, _torchrun  # noqa: E402

RTOL_REF = 1e-5  # the reference sharded against the reference unsharded

FORWARD_CASES = (
    ("yi-9b", "int8", "2x2"),
    ("yi-9b", "int8-per-tensor", "1x4"),
    ("qwen3-moe-235b-a22b", "int8", "2x2"),
)


def _moe_cf16(cfg):
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def test_sharded_int8_forwards_in_gloo_processes(tmp_path):
    """The three forward cases in one 4-rank launch: each within 1e-5 of
    the port's single-process forward under its policy and within 2e-3 of
    JAX's unsharded forward; then the split products, each rank's part
    bit for bit; yi-9b's loss and gradients with remat under both policies
    within 1e-5 of one process's."""
    rng = np.random.default_rng(0)
    archs = sorted({arch for arch, _, _ in FORWARD_CASES})
    jparams, toks = {}, {}
    for arch in archs:
        jparams[arch] = jm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
        toks[arch] = rng.integers(0, jax_smoke_config(arch).vocab_size, (4, 32)).astype(np.int32)
        _save_params(tmp_path / f"{arch}.npz", jparams[arch])
        np.save(tmp_path / f"{arch}.tokens.npy", toks[arch])
    _torchrun(4, [WORKER, "int8", tmp_path, *(":".join(c) for c in FORWARD_CASES)], tmp_path)
    for arch, quant, shape in FORWARD_CASES:
        jcfg = _moe_cf16(jax_smoke_config(arch, quant))
        tcfg = _moe_cf16(get_smoke_config(arch, quant))
        assert tcfg.activation_dtype == torch.float32 and tcfg.quant is not None
        jref = np.asarray(jm.forward(jparams[arch], jcfg, tokens=jnp.asarray(toks[arch])), np.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jparams[arch]), "cpu")
        with torch.no_grad():
            tref = tm.forward(tp, tcfg, tokens=torch.from_numpy(toks[arch])).numpy()
        out = np.load(tmp_path / f"{arch}.{quant}.{shape}.out.npy")
        case = f"{arch} --quant {quant} --mesh {shape}"
        err_port = float(np.abs(out - tref).max())
        err_jax = float(np.abs(out - jref).max())
        assert err_port <= ATOL_FP32, f"{case}: {err_port} from the port's unsharded forward"
        assert err_jax <= ATOL_JAX, f"{case}: {err_jax} from JAX's unsharded forward"
    products = json.loads((tmp_path / "int8_products.json").read_text())
    assert len(products) == 4 and len(products[0]) == 10
    for rank, errors in enumerate(products):
        assert errors == dict.fromkeys(errors, 0.0), f"rank {rank}: {errors}"
    grads = json.loads((tmp_path / "int8_grads.json").read_text())
    assert set(grads) == {"int8", "int8-per-tensor"}
    for quant, errors in grads.items():
        assert errors["loss"] <= ATOL_FP32 and errors["grad"] <= ATOL_FP32, f"{quant}: {errors}"


def test_int8_under_a_1x1_gloo_mesh_runs_no_collective(monkeypatch):
    """Nothing is sharded at model 1: under a world-size-1 gloo group and a
    1 x 1 mesh the int8 forward (yi-9b smoke, per channel and per tensor)
    equals the no-mesh one bit for bit and no int8 product reduces."""
    import torch.distributed as dist

    from repro_torch.dist import param_shardings, place, set_mesh
    from repro_torch.dist.collectives import full
    from repro_torch.launch.mesh import ensure_process_group, make_debug_mesh
    from repro_torch.quant import quantize

    calls = []
    monkeypatch.setattr(quantize, "_all_reduce", lambda *a: calls.append(a))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32))
    made = ensure_process_group(1, "cpu")
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        for quant in ("int8", "int8-per-tensor"):
            cfg = get_smoke_config("yi-9b", quant)
            params = tm.init_params(cfg, 0, device="cpu")
            placed = place(params, param_shardings(params, cfg, mesh))
            with torch.no_grad():
                want = tm.forward(params, cfg, tokens=toks)
                with set_mesh(mesh):
                    got = full(tm.forward(placed, cfg, tokens=toks))
            assert torch.equal(got, want), quant
    finally:
        if made:
            dist.destroy_process_group()
    assert calls == []


@pytest.mark.parametrize("quant", ["int8", "int8-per-tensor"])
def test_serve_launcher_mesh_2x2_int8_equals_sequential_decode(tmp_path, quant):
    """``launch.serve --arch olmo-1b --check --mesh 2x2 --quant QUANT``:
    every request gets unsharded sequential decode's tokens."""
    out = _torchrun(4, ["-m", "repro_torch.launch.serve", "--arch", "olmo-1b", "--check", "--device", "cpu",
                        "--mesh", "2x2", "--quant", quant], tmp_path)
    assert out.stdout.count("check OK: all 8 outputs match sequential decode") == 4, out.stdout[-3000:]


def test_train_launcher_int8_mesh_1x2_matches_single_process(tmp_path):
    """``launch.train --smoke --quant int8 --mesh 1x2`` (model 2) for 2
    steps: the single-process launcher's losses within 1e-5."""
    args = ["-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--smoke", "--steps", "2",
            "--batch", "4", "--seq", "32", "--device", "cpu", "--ckpt-every", "100", "--quant", "int8"]
    _torchrun(1, [*args, "--ckpt-dir", tmp_path / "ck1", "--metrics-out", tmp_path / "one.prom"], tmp_path)
    out = _torchrun(2, [*args, "--ckpt-dir", tmp_path / "ck2", "--metrics-out", tmp_path / "two.prom",
                        "--mesh", "1x2"], tmp_path)
    assert "mesh {'data': 1, 'model': 2}" in out.stdout

    def losses(name):
        lines = (tmp_path / f"{name}.prom.jsonl").read_text().splitlines()
        return [json.loads(line)["loss"] for line in lines]

    one, two = losses("one"), losses("two")
    assert len(one) == len(two) == 2
    np.testing.assert_allclose(two, one, atol=ATOL_FP32, rtol=0)


@pytest.mark.parametrize("per_channel", [True, False], ids=["per_channel", "per_tensor"])
@pytest.mark.parametrize("split", ["contraction", "columns"])
def test_reference_int8_dot_is_global_under_a_mesh(per_channel, split):
    """The reference's jitted ``int8_dot`` with x [8, 64] @ w [64, 32]
    split over 2 CPU devices equals its unsharded result within 1e-5
    relative: GSPMD keeps the whole array's scales and int32 sum."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    want = np.asarray(jax_int8_dot(jnp.asarray(x), jnp.asarray(w), per_channel=per_channel))
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    xs, ws = (PartitionSpec(None, "model"), PartitionSpec("model", None)) if split == "contraction" else (
        PartitionSpec(), PartitionSpec(None, "model"))
    fn = jax.jit(lambda a, b: jax_int8_dot(a, b, per_channel=per_channel))
    got = np.asarray(fn(jax.device_put(x, NamedSharding(mesh, xs)), jax.device_put(w, NamedSharding(mesh, ws))))
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= RTOL_REF * scale
