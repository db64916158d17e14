"""The port's public API against repro's, and its examples.

* Every module of ``src/repro/`` has a counterpart under ``repro_torch``
  that holds each of its public names: the names a module defines at top
  level (functions, classes, assignments) or lists in ``__all__``, and the
  names a package's ``__init__`` re-exports.  Left out, each with its
  reason, are the names that mean something only on a TPU or to XLA.
* ``pwl_exp`` and ``exp2_reference`` against the reference's.
* Each ``examples/*_torch.py`` runs with ``--device cpu`` at its smallest
  flags.
"""

import ast
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

jax_pwl = importlib.import_module("repro.core.pwl_exp2")  # the package's pwl_exp2 is the function
torch_pwl = importlib.import_module("repro_torch.core.pwl_exp2")

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro"

# Meaningful only on a TPU or to XLA: (module, name) -> reason.
TPU_ONLY = {
    ("repro.compat", None): "shims for JAX versions (jax.set_mesh, AxisType, shard_map); nothing to port",
    ("repro.core.pwl_exp2", "pwl_coeffs"): "packs the Pallas kernel's lane-padded operand as a jnp array",
    ("repro.kernels.pwl_exp2", "pwl_exp2_pallas"): "the Pallas kernel itself; the port's is pwl_exp2_cuda",
    ("repro.kernels.pwl_exp2.kernel", "pwl_exp2_pallas"): "the Pallas kernel itself; the port's is pwl_exp2_cuda",
    ("repro.kernels.pwl_exp2.kernel", "LANES"): "the TPU's 128-lane vreg width of the Pallas block",
    ("repro.kernels.pwl_exp2.kernel", "DEFAULT_BLOCK_ROWS"): "the Pallas kernel's row block",
    ("repro.launch.roofline", "analyze_compiled"): "reads XLA's compiled HLO cost analysis",
    ("repro.launch.roofline", "collective_bytes"): "parses collectives out of XLA's HLO text",
}


def _modules():
    for path in sorted(REFERENCE.rglob("*.py")):
        parts = list(path.relative_to(REFERENCE.parent).with_suffix("").parts)
        is_init = parts[-1] == "__init__"
        yield ".".join(parts[:-1] if is_init else parts), path, is_init


def _public(path: Path, is_init: bool) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                names.update(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif is_init and isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


MODULES = list(_modules())


@pytest.mark.parametrize("module, path, is_init", MODULES, ids=[m for m, _, _ in MODULES])
def test_every_public_name_has_a_counterpart(module, path, is_init):
    if (module, None) in TPU_ONLY:
        assert path.exists()
        return
    ported = importlib.import_module("repro_torch" + module[len("repro"):])
    public = _public(path, is_init)
    excluded = {name for (mod, name) in TPU_ONLY if mod == module}
    assert excluded <= public, f"stale exclusions: {excluded - public}"
    missing = sorted(n for n in public - excluded if not hasattr(ported, n))
    assert not missing, f"{ported.__name__} lacks {missing}"


def test_the_papers_api_imports():
    from repro_torch.core import figure11, naive_attention, pwl_exp, systolic_attention  # noqa: F401
    from repro_torch.dist import pipelined_apply  # noqa: F401
    from repro_torch.obs import watch_jit_compiles  # noqa: F401
    from repro_torch.optim import compressed_pmean  # noqa: F401


def test_pwl_exp_and_exp2_reference_equal_the_reference():
    """``pwl_exp`` bit for bit in fp32 (the reference's scale by log2 e,
    then its PWL exp2).  ``exp2_reference`` within 1 fp32 ulp of exp2 in
    fp64; the reference's (XLA's exp2 on the CPU) is the less exact one,
    held within 16."""
    x = np.concatenate([np.linspace(-90.0, 0.0, 4001, dtype=np.float32), np.float32([-0.0, -1e-8, -87.3])])
    for k in (4, 8, 16):
        got = torch_pwl.pwl_exp(torch.from_numpy(x), num_segments=k).numpy()
        want = np.asarray(jax_pwl.pwl_exp(jnp.asarray(x), num_segments=k))
        np.testing.assert_array_equal(got, want)
    y = np.linspace(-30.0, 10.0, 1001, dtype=np.float32)
    exact = np.exp2(y.astype(np.float64))
    ulp = np.spacing(exact.astype(np.float32)).astype(np.float64)
    got = torch_pwl.exp2_reference(torch.from_numpy(y)).numpy()
    ref = np.asarray(jax_pwl.exp2_reference(jnp.asarray(y)))
    assert got.dtype == ref.dtype == np.float32
    assert np.all(np.abs(got - exact) <= ulp)
    assert np.all(np.abs(ref - exact) <= 16 * ulp)


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_lm_torch", "fsa_kernel_demo_torch"])
def test_example_runs_on_the_cpu(monkeypatch, capsys, name):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--device", "cpu"])
    _load_example(name).main()
    out = capsys.readouterr().out
    assert {"quickstart_torch": "speedups 1.77x / 4.83x",
            "serve_lm_torch": "greedy determinism across batching: True",
            "fsa_kernel_demo_torch": "cycles: 11504 (5N+10 model: 11504)"}[name] in out


def test_train_example_resumes_on_the_cpu(monkeypatch, capsys, tmp_path):
    """``train_lm_torch.py --device cpu`` past its warm-up (30 steps), its ~100M
    config narrowed to 2 layers of 64 so that a CPU test can hold its
    checkpoints: the loss falls, and a fresh trainer resumes from the last
    checkpoint."""
    import dataclasses

    mod = _load_example("train_lm_torch")
    monkeypatch.setattr(mod, "CFG_100M", dataclasses.replace(
        mod.CFG_100M, num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=512))
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--device", "cpu", "--steps", "30", "--batch", "2",
                                      "--seq", "16", "--ckpt-dir", str(tmp_path)])
    mod.main()
    assert "resumed from step 30 -> 40 OK" in capsys.readouterr().out
