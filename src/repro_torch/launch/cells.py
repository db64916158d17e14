"""Dry-run cell machinery (counterpart of ``repro.launch.cells``): meta
inputs, and one (architecture x input shape x mesh) step traced on meta
DTensors.

Nothing is allocated: params, optimizer state, batch and cache are meta
tensors placed by ``repro_torch.dist.sharding`` on a mesh over a fake
process group, and ``lower_cell`` runs one train step (loss, backward,
optimizer update), prefill step or decode step eagerly on them under
``launch.roofline.CostMode``.  A cell that traces is the proof that the
sharding rules and the model's islands are coherent for that mesh; the
reference's proof is ``lower(...).compile()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Union

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.dist.collectives import set_mesh
from repro_torch.dist.sharding import (
    batch_pspec,
    cache_shardings,
    local_bytes,
    param_shardings,
    place,
    zero1_shardings,
)
from repro_torch.models.model import init_cache, param_shapes
from repro_torch.optim.adamw import make_optimizer
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step
from .roofline import CostMode

# Archs whose optimizer state must be Adafactor + ZeRO-1 to fit memory.
ADAFACTOR_ARCHS = {"arctic-480b", "qwen3-moe-235b-a22b"}


def sds(shape, dtype) -> torch.Tensor:
    """The reference's ``jax.ShapeDtypeStruct``: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta stand-ins for every model input of this cell."""
    gb, s = shape.global_batch, shape.seq_len
    act = cfg.activation_dtype
    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {}
        if cfg.embedding_inputs:
            batch["embeds"] = sds((gb, s, cfg.d_model), act)
        else:
            batch["tokens"] = sds((gb, s), torch.int32)
        if cfg.mrope_sections is not None:
            batch["positions"] = sds((gb, s, 3), torch.int32)
        if shape.kind == "train":
            batch["labels"] = sds((gb, s), torch.int32)
        return {"batch": batch}
    # decode: one new token against a cache of length seq_len
    return {
        "tokens": sds((gb, 1), torch.int32),
        "position": sds((), torch.int32),
        "cache": init_cache(cfg, gb, s, device="meta"),
    }


@dataclasses.dataclass
class LoweredCell:
    arch: str
    shape_name: str
    kind: str
    mesh_desc: str
    cost: CostMode  # the trace's FLOPs, bytes, collectives and peak
    arg_bytes: int  # local bytes of the placed arguments
    donated_bytes: int  # local bytes of outputs that replace donated arguments
    trace_s: float  # seconds the step's trace took
    meta: dict


def _new_bytes(new: Any, old: Any) -> int:
    """Local bytes of ``new``'s leaves that are not ``old``'s (a cache
    written in place keeps its KV leaves)."""
    if isinstance(new, dict):
        return sum(_new_bytes(new[k], old[k]) for k in new)
    if isinstance(new, tuple):
        return sum(_new_bytes(n, o) for n, o in zip(new, old))
    return 0 if new is old else local_bytes(new)


def dryrun_config(cfg: ModelConfig, shape: ShapeConfig, scan_unroll: int = 1) -> ModelConfig:
    """The reference's dry-run overrides: larger attention blocks (seq/8,
    at least 128, unless tuned) and the scan unroll.  In an eager trace
    every layer and every block is counted anyway; the larger blocks keep
    the plain tiled attention's loop short."""
    block = max(128, shape.seq_len // 8)
    bq = cfg.attn_block_q if cfg.attn_block_q != 128 else block
    bk = cfg.attn_block_k if cfg.attn_block_k != 128 else block
    return dataclasses.replace(
        cfg, scan_unroll=scan_unroll, attn_unroll=True, attn_block_q=bq, attn_block_k=bk,
    )


def lower_cell(
    arch: str,
    shape_name: Union[str, ShapeConfig],
    mesh,
    *,
    cfg_override: Optional[ModelConfig] = None,
    scan_unroll: int = 0,  # 0 = plain production config (no dry-run overrides)
    num_microbatches: int = 1,
    donate: bool = True,
) -> LoweredCell:
    """Trace one step of the cell on meta DTensors over ``mesh`` (a mesh
    of a fake process group; ``shape_name`` a name in ``SHAPES`` or a
    ``ShapeConfig``).  ``donate`` counts the outputs that replace the
    params and optimizer state (train) or the cache (decode) as aliased,
    as the reference's donated jit arguments are."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if scan_unroll:
        cfg = dryrun_config(cfg, shape, scan_unroll)
    pshapes = param_shapes(cfg)
    params = place(pshapes, param_shardings(pshapes, cfg, mesh))
    specs = input_specs(cfg, shape)
    mesh_desc = "x".join(str(n) for n in mesh.shape)
    meta_rec: dict = {}
    with set_mesh(mesh), torch.no_grad():
        if shape.kind == "train":
            opt_name = "adafactor" if arch in ADAFACTOR_ARCHS else "adamw"
            optimizer = make_optimizer(opt_name, lr=3e-4)
            oshapes = optimizer.init(pshapes)
            opt = place(oshapes, zero1_shardings(oshapes, cfg, mesh))
            batch = place(specs["batch"], batch_pspec(specs["batch"], mesh, cfg))
            args = (params, opt, batch)
            step = make_train_step(cfg, optimizer, num_microbatches=num_microbatches)
            meta_rec["optimizer"] = opt_name
        elif shape.kind == "prefill":
            batch = place(specs["batch"], batch_pspec(specs["batch"], mesh, cfg))
            args = (params, batch)
            step = make_prefill_step(cfg)
        else:  # decode
            cache = place(specs["cache"], cache_shardings(specs["cache"], cfg, mesh))
            tokens = place(specs["tokens"], batch_pspec(specs["tokens"], mesh))
            args = (params, cache, tokens, specs["position"])
            step = make_decode_step(cfg)
        cost = CostMode()
        t0 = time.perf_counter()
        with cost:
            out = step(*args)
        trace_s = time.perf_counter() - t0
    donated = 0
    if donate and shape.kind == "train":
        donated = local_bytes(out[:2])  # the new params and optimizer state
    elif donate and shape.kind == "decode":
        donated = _new_bytes(out[2], args[1])  # the cache's new leaves

    meta_rec.update(
        {
            "params": int(cfg.param_count()),
            "active_params": int(cfg.active_param_count()),
            "global_batch": shape.global_batch,
            "seq_len": shape.seq_len,
        }
    )
    return LoweredCell(arch, shape.name, shape.kind, mesh_desc, cost, local_bytes(args),
                       donated, trace_s, meta_rec)
