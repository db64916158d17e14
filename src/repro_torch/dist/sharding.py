"""Path-based partition rules over the ("pod", "data", "model") mesh
(counterpart of ``repro.dist.sharding``).

Conventions (Megatron TP+DP+SP with ZeRO-1 optimizer state):

  * "model": tensor parallelism.  Column-parallel projections (wq/wk/wv,
    MLP gate/up, SSM in_proj) shard their *output* dim; row-parallel
    projections (wo, MLP down, SSM out_proj) shard their *input* dim;
    embeddings shard the vocab dim; MoE expert banks shard the expert dim
    (expert parallelism, ``repro_torch.models.moe``).
  * "data": data parallelism.  Parameters are replicated over it; the
    optimizer state is additionally partitioned over it (ZeRO-1); batches
    shard their leading dim over ("pod", "data").
  * "pod": folds into data parallelism here.

Every rule is *fitted*: an axis is only emitted when the dim size divides
the axis-size product, so undividable dims degrade to replication.
``param_pspec`` is the pure rule and returns the reference's spec as a
``P`` (a tuple of entries: None, an axis name, or a tuple of names); the
``*_shardings`` helpers close over a ``DeviceMesh`` and return trees of
``NamedSharding`` (mesh, spec, and the DTensor ``placements``), which
``place`` applies with ``distribute_tensor``.

Tree paths are the reference's: "/"-joined dict keys and NamedTuple field
names ("layers/attn/wq", "m/layers/mlp/up", "stats/layers/attn/wq/r").
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.base import ModelConfig
from .collectives import P, mesh_sizes, placements, tree_zip

DATA_AXES = ("pod", "data")

# Projections whose output (last) dim is TP-sharded.
_COL_PARALLEL = {
    "wq", "wk", "wv", "bq", "bk", "bv",  # attention QKV (+bias)
    "gate", "up",                        # MLP in-projections
    "in_proj",                           # mamba2
    "wi", "wf", "wz",                    # xLSTM gate in-projections
}
# Projections whose input (second-to-last) dim is TP-sharded.
_ROW_PARALLEL = {"wo", "down", "out_proj"}
# Adafactor factored-stat leaves: strip to reach the param path.
_STAT_LEAVES = {"r", "c", "v"}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _fit(entry, dim_size: int, sizes: dict[str, int]):
    """Keep an axis group only if every axis exists and the product divides."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if sizes.get(a, 0) > 1)
    total = 1
    for a in axes:
        total *= sizes[a]
    if not axes or dim_size % total != 0:
        return None
    return axes[0] if len(axes) == 1 else axes


def param_pspec(path: str, shape: tuple[int, ...], cfg: ModelConfig, data_size: int,
                model_size: int) -> P:
    """Partition spec for one parameter leaf, identified by its tree path.

    Stacked layer params carry a leading layer dim which is never sharded;
    the rules address dims from the trailing end."""
    sizes = {"data": data_size, "model": model_size}
    parts = [p for p in re.split(r"[./]", path) if p]
    name = parts[-1] if parts else ""
    if name in _STAT_LEAVES and len(parts) > 1:  # adafactor r/c/v stats
        name = parts[-2]
    rank = len(shape)
    spec: list[Any] = [None] * rank

    if rank == 0:
        return P()
    if name == "embed":
        spec[0] = "model"  # vocab dim
    elif name == "lm_head":
        spec[rank - 1] = "model"  # [d, V]
    elif parts and "moe" in parts and name in ("gate", "up", "down") and rank >= 3:
        spec[rank - 3] = "model"  # expert dim: EP
    elif name == "router":
        pass  # replicated (fp32, tiny, read by every rank)
    elif name in _COL_PARALLEL and rank >= 1:
        spec[rank - 1] = "model"
    elif name in _ROW_PARALLEL and rank >= 2:
        spec[rank - 2] = "model"

    return P(*[_fit(e, shape[d], sizes) for d, e in enumerate(spec)])


def tree_map_with_path(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over dicts, lists, tuples and NamedTuples (None
    leaves stay None); paths join dict keys and field names with "/"."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map_with_path(fn, v, f"{path}/{k}" if path else k) for k, v in zip(tree._fields, tree)
        ))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def param_shardings(pshapes: Any, cfg: ModelConfig, mesh) -> Any:
    """NamedSharding tree for the parameters (TP over "model")."""
    sizes = mesh_sizes(mesh)
    data, model = sizes.get("data", 1), sizes.get("model", 1)
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(path, tuple(leaf.shape), cfg, data, model)),
        pshapes,
    )


def zero1_shardings(oshapes: Any, cfg: ModelConfig, mesh) -> Any:
    """Optimizer-state shardings: the param's TP layout plus a ZeRO-1
    partition, the first still-replicated divisible dim of every stat
    sharded over "data"."""
    sizes = mesh_sizes(mesh)
    data, model = sizes.get("data", 1), sizes.get("model", 1)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = list(param_pspec(path, shape, cfg, data, model))
        if data > 1:
            for d in range(len(shape)):
                if spec[d] is None and shape[d] % data == 0 and shape[d] >= data:
                    spec[d] = "data"
                    break
        return NamedSharding(mesh, P(*spec))

    return tree_map_with_path(one, oshapes)


def batch_pspec(batch: Any, mesh, cfg: Optional[ModelConfig] = None) -> Any:
    """Batch shardings: leading (global-batch) dim over every data axis
    present on the mesh; scalars replicated."""
    del cfg  # uniform across archs, kept for call-site symmetry
    sizes = mesh_sizes(mesh)
    daxes = tuple(a for a in DATA_AXES if sizes.get(a, 0) > 1)

    def one(_path, leaf):
        shape = tuple(leaf.shape)
        entry = _fit(daxes, shape[0], sizes) if shape else None
        if entry is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(entry, *([None] * (len(shape) - 1))))

    return tree_map_with_path(one, batch)


def cache_shardings(cache: Any, cfg: ModelConfig, mesh) -> Any:
    """KV/state-cache shardings.  Every stacked cache leaf is [L, B, ...]:
    the batch dim (1) shards over the data axes; floating leaves of rank
    >= 4 also shard their dim rank-2 (KV heads of [L, B, S, H, d]) over
    "model"; integer leaves (``lengths``) only the batch dim.  An int8 KV
    cache shards payloads and per-token scales on the head dim (3)."""
    from repro_torch.models.attention import QuantKVCache  # lazy: models import dist

    sizes = mesh_sizes(mesh)
    daxes = tuple(a for a in DATA_AXES if sizes.get(a, 0) > 1)

    def spec_for(shape, model_dim=None):
        rank = len(shape)
        spec: list[Any] = [None] * rank
        if rank >= 2:
            spec[1] = _fit(daxes, shape[1], sizes)
        if model_dim is not None and rank > model_dim:
            spec[model_dim] = _fit("model", shape[model_dim], sizes)
        return NamedSharding(mesh, P(*spec))

    def one(_path, leaf):
        shape = tuple(leaf.shape)
        rank = len(shape)
        return spec_for(shape, rank - 2 if rank >= 4 and leaf.dtype.is_floating_point else None)

    def node(x):
        if isinstance(x, QuantKVCache):
            return QuantKVCache(
                k=spec_for(tuple(x.k.shape), 3),
                v=spec_for(tuple(x.v.shape), 3),
                k_scale=spec_for(tuple(x.k_scale.shape), 3),
                v_scale=spec_for(tuple(x.v_scale.shape), 3),
                lengths=spec_for(tuple(x.lengths.shape)),
            )
        if isinstance(x, dict):
            return {k: node(v) for k, v in x.items()}
        return tree_map_with_path(one, x)

    return node(cache)


def place(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor with its sharding's
    placements.  A leaf must hold the same full value on every rank (made
    from one seed, or a meta tensor); each rank keeps its own shard."""

    def one(leaf, sh):
        if leaf is None:
            return None
        if isinstance(leaf, DTensor):
            return leaf.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(leaf, sh.mesh, sh.placements, src_data_rank=None)

    return tree_zip(one, tree, shardings)


def spec_of(x) -> P:
    """The spec of a DTensor's placements (a plain tensor: replicated)."""
    if not isinstance(x, DTensor):
        return P()
    entries: list[Any] = [None] * x.ndim
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            d = p.dim % x.ndim
            e = entries[d]
            entries[d] = name if e is None else ((e,) if isinstance(e, str) else tuple(e)) + (name,)
    return P(*entries)


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards of a tree's tensor leaves."""
    total = 0

    def one(x, _):
        nonlocal total
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()

    tree_zip(one, tree, tree)
    return total
