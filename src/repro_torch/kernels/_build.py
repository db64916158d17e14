"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library that ``ctypes`` loads. A build happens
at first use, on the machine with the card, and lands in
``$REPRO_TORCH_BUILD_DIR``, by default ``build/repro_torch_kernels/`` at the
root of the checkout (git-ignored), under a name keyed by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
reused. An installed copy of the package has no checkout above it and must
be given ``REPRO_TORCH_BUILD_DIR``.

Each finished build logs one record to the ``repro_torch.kernels.build``
logger (at DEBUG); ``obs.watch_jit_compiles`` counts them.  Loading a
library already built logs nothing.

Never ``--use_fast_math``: it flushes subnormals in the exact path and
swaps ``exp2f`` for ``ex2.approx``, which changes results the tests hold.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd", "flash_bwd", "pwl_exp2", "decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
)

_libs: dict[str, ctypes.CDLL] = {}
_log = logging.getLogger("repro_torch.kernels.build")  # obs.metrics.BUILD_LOGGER


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch_kernels`` of the
    checkout that holds this file (``<root>/src/repro_torch/kernels``)."""
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    src = Path(__file__).resolve().parents[2]
    if src.name != "src" or not (src.parent / "pyproject.toml").is_file():
        raise RuntimeError(
            f"{__file__} is not in a checkout of the repo; "
            "set REPRO_TORCH_BUILD_DIR to where the kernels should be built"
        )
    return src.parent / "build" / "repro_torch_kernels"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library is built:
    ``(process, temporary output)``, or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, time.perf_counter()


def _finish(name: str, started) -> Path:
    """Wait for a build from ``_start``; keep the compiler's output (ptxas's
    register and spill report) beside the library as ``.log``."""
    out = library_path(name)
    if started is None:
        return out
    proc, tmp, t0 = started
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(stdout + stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    _log.debug("Finished nvcc build of %s in %.3f sec", name, time.perf_counter() - t0)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return _finish(name, _start(name))


def build_all() -> dict[str, Path]:
    """Build every kernel source, one ``nvcc`` per source, all at once."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, proc) for name, proc in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]
