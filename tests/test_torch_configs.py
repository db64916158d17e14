"""repro_torch configs against repro's, and the port's import isolation."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jax_registry  # noqa: E402
from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.quant import get_quant  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_config_equals_reference(arch, kind):
    getter = "get_config" if kind == "full" else "get_smoke_config"
    ours = getattr(torch_registry, getter)(arch)
    ref = getattr(jax_registry, getter)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.activation_dtype == getattr(torch, ref.dtype)
    assert ours.param_count() == ref.param_count()


def test_int8_policy_parses_and_is_refused():
    """The int8 policy parses, equals the reference's, and is active (the
    name is kept from when the port refused it)."""
    ours = torch_registry.get_smoke_config("olmo-1b", "int8")
    ref = jax_registry.get_smoke_config("olmo-1b", "int8")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    quant = get_quant(ours)
    assert quant.per_channel and quant.quantized_kv
    assert all(quant.active(cls) for cls in ("mlp", "attention", "moe"))


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch, and chip_smoke, import without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "for want in ('repro_torch.launch.serve', 'repro_torch.bridge', 'repro_torch.launch.tune',\n"
        "             'repro_torch.models.moe', 'repro_torch.quant.quantize', 'repro_torch.optim.grad_compress',\n"
        "             'repro_torch.kernels.pwl_exp2.kernel', 'repro_torch.core.fsa_sim'):\n"
        "    assert want in names, (want, names)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
