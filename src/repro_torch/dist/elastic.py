"""Elastic mesh rescale: resume any checkpoint on any valid mesh shape
(counterpart of ``repro.dist.elastic``).

Checkpoints store unsharded logical tensors (``repro_torch.checkpoint``);
re-placing them on another device mesh is a pure sharding decision.
``rescale_plan`` validates that the model's dimensions divide the new mesh
and derives the parameter and optimizer-state sharding trees;
``apply_rescale`` places a restored state tree on them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from .collectives import mesh_sizes
from .sharding import param_shardings, place, zero1_shardings


@dataclasses.dataclass
class RescalePlan:
    old_devices: Optional[int]
    new_devices: int
    mesh: Any
    param_shardings: Any
    opt_shardings: Any


def _validate(cfg: ModelConfig, mesh) -> None:
    sizes = mesh_sizes(mesh)
    model = sizes.get("model", 1)
    problems = []
    if model > 1:
        if cfg.num_heads % model:
            problems.append(
                f"num_heads={cfg.num_heads} not divisible by model axis {model}"
            )
        if cfg.num_kv_heads % model and cfg.num_heads % model == 0:
            problems.append(
                f"num_kv_heads={cfg.num_kv_heads} not divisible by model axis {model}"
            )
        if cfg.d_ff % model:
            problems.append(
                f"d_ff={cfg.d_ff} not divisible by model axis {model}"
            )
        if cfg.vocab_size % model:
            problems.append(
                f"vocab_size={cfg.vocab_size} not divisible by model axis "
                f"{model} (embedding shards the vocab dim)"
            )
        if cfg.moe is not None and cfg.moe.num_experts % model:
            problems.append(
                f"num_experts={cfg.moe.num_experts} not divisible by "
                f"model axis {model} (expert parallelism)"
            )
    if problems:
        raise ValueError(
            f"mesh {dict(sizes)} incompatible with {cfg.name}: "
            + "; ".join(problems)
        )


def rescale_plan(
    cfg: ModelConfig,
    pshapes: Any,
    oshapes: Any,
    new_mesh,
    *,
    old_devices: Optional[int] = None,
) -> RescalePlan:
    """Derive shardings for resuming on ``new_mesh``; raises ValueError if
    the model cannot be laid out on it."""
    _validate(cfg, new_mesh)
    return RescalePlan(
        old_devices=old_devices,
        new_devices=math.prod(mesh_sizes(new_mesh).values()),
        mesh=new_mesh,
        param_shardings=param_shardings(pshapes, cfg, new_mesh),
        opt_shardings=zero1_shardings(oshapes, cfg, new_mesh),
    )


def apply_rescale(state: Any, shardings: Any) -> Any:
    """Place a (restored, host-resident) state tree onto new shardings."""
    return place(state, shardings)
