"""Device meshes (counterpart of ``repro.launch.mesh``), on
``torch.distributed.device_mesh``.

Defined as functions, never module-level constants: importing this module
touches no distributed state.  Each mesh needs a default process group of
its size, which the caller makes (``torchrun`` and NCCL on the card, gloo on
the CPU, or the dry-run's fake group; ``ensure_process_group`` makes a
world-size-1 group where none exists).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16 x 16 = 256 devices over ("data", "model"); with ``multi_pod``,
    (pod=2, data=16, model=16) = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1, *, device_type=None):
    """A (data, model) mesh over the default group's ``data * model`` ranks."""
    return init_device_mesh(_device_type(device_type), (data, model), mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism (pod folds into DP by default)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def model_axis_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))


def parse_mesh(flag: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model)."""
    data, model = (int(x) for x in flag.lower().split("x"))
    return data, model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(world_size: int, device_type=None) -> bool:
    """The default process group for a ``world_size``-rank mesh: the one
    ``torchrun`` describes in the environment (NCCL on the card, gloo on the
    CPU), or, for one rank and no group, a world-size-1 group on a free
    local port.  Returns whether it made the group (the caller then
    destroys it)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise SystemExit(f"the mesh needs {world_size} ranks; the process group has {dist.get_world_size()}")
        return False
    backend = "nccl" if _device_type(device_type) == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise SystemExit(f"the mesh needs {world_size} ranks; torchrun started {os.environ['WORLD_SIZE']}")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return True
    if world_size != 1:
        raise SystemExit(
            f"a {world_size}-rank mesh runs under torchrun --nproc-per-node {world_size}"
        )
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0
    )
    return True
