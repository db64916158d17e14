"""Mesh-aware logical constraints and local islands (counterpart of
``repro.dist.collectives``).

The ambient mesh is set by ``set_mesh`` (the reference's ``jax.set_mesh``).
``constrain`` is the one entry point model code uses to express layout
intent (Megatron-SP residual sharding, ...), as in the reference: axis names
the mesh lacks are dropped, dims whose size the named axes do not divide
(or whose axes' product is 1) are left unconstrained, and without a mesh, or
for a tensor that is not a DTensor, it is the identity; otherwise it
redistributes the DTensor to the fitted placements.

``local_island`` plays ``shard_map``'s part: it runs a function on the
local shards of its DTensor arguments, each first redistributed to the
placements of its spec, and wraps the results as DTensors, optionally as
partial sums over mesh axes (reduced by DTensor at the next op that needs
them).  Model code runs in such islands where an op has no sharding rule or
reads ``data_ptr()`` (the CUDA kernels), or where an explicit layout is the
point (expert parallelism).
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

AxisSpec = Union[None, str, Sequence[str]]

_MESHES: list = []


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (None: no mesh)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def get_mesh():
    """The ambient mesh, or None."""
    return _MESHES[-1] if _MESHES else None


def _ambient_axis_names() -> tuple[str, ...]:
    """Axis names of the mesh currently in scope (() when unsharded)."""
    mesh = get_mesh()
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def mesh_sizes(mesh) -> dict[str, int]:
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _resolve_entry(entry: AxisSpec, dim_size: int, sizes: dict[str, int]) -> AxisSpec:
    """Filter one spec entry against a mesh (the reference's rule)."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if a in sizes)
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= sizes[a]
    if total == 1 or dim_size % total != 0:
        return None
    return axes[0] if len(axes) == 1 else axes


def placements(spec: Sequence[AxisSpec], mesh, partial: Sequence[str] = ()) -> tuple:
    """DTensor placements, one per mesh dim, of an (already fitted) spec:
    a mesh axis that shards tensor dim d is ``Shard(d)``, one named in
    ``partial`` is ``Partial()``, the rest ``Replicate()``.  Axes grouped on
    one dim shard it major to minor in mesh order, as a PartitionSpec's
    tuple entry does."""
    out = []
    for name in mesh.mesh_dim_names:
        p = Partial() if name in partial else Replicate()
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if name in axes:
                p = Shard(d)
        out.append(p)
    return tuple(out)


def constrain(x: torch.Tensor, *spec: AxisSpec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against the ambient mesh,
    forgivingly: a redistribution of a DTensor, the identity otherwise."""
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = mesh_sizes(mesh)
    entries = [
        _resolve_entry(spec[d] if d < len(spec) else None, x.shape[d], sizes)
        for d in range(x.ndim)
    ]
    if all(e is None for e in entries):
        return x
    target = placements(entries, mesh)
    return x if tuple(x.placements) == target else x.redistribute(mesh, target)


def psum_mean(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """Mean of a local tensor across one mesh axis (island bodies only), by
    a functional all-reduce on that axis's process group."""
    import torch.distributed._functional_collectives as funcol

    mesh = mesh if mesh is not None else get_mesh()
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    return funcol.all_reduce(x, "sum", mesh.get_group(axis_name)) / n


def tree_zip(fn, tree, other):
    """``fn(leaf, other_leaf)`` over a tree (dicts, lists, tuples,
    NamedTuples) and a tree ``other`` of its structure, whose leaves may be
    anything but a tuple that is not a ``P``."""
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(other, P):
        items = [tree_zip(fn, v, o) for v, o in zip(tree, other)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, other)


def local_island(fn, args: tuple, in_specs: tuple, out_specs: Any, *, mesh=None,
                 partial: Sequence[str] = (), varying: Sequence[str] = ()):
    """``fn(*local_args)`` on local shards, the reference's ``shard_map``.

    Each tensor leaf of ``args`` (a DTensor, or a plain tensor taken as the
    same global value on every rank) is redistributed to the placements of
    its ``P`` in ``in_specs`` (a tree of ``args``'s structure) and passed as
    its local shard; non-tensors pass as they are.  The leaves of ``fn``'s
    result become DTensors with ``out_specs`` (a ``P`` for every leaf, or a
    tree of them), summed over the mesh axes in ``partial``.  Without a mesh
    ``fn`` runs on ``args`` as they are.

    Gradients: on a mesh axis over which the island's work differs (an
    output sharded or partial there, or an axis in ``varying``: one whose
    shards ``fn`` itself reduces to a replicated output), a replicated
    input's local gradient is a partial sum; elsewhere it keeps the
    input's placement.
    """
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return fn(*args)
    distinct = set(partial) | set(varying)
    for spec in _spec_leaves(out_specs):
        for entry in spec:
            distinct.update((entry,) if isinstance(entry, str) else tuple(entry or ()))
    names = mesh.mesh_dim_names

    def to_local(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = replicate(leaf, mesh)
        target = placements(spec if spec is not None else P(), mesh)
        if tuple(leaf.placements) != target:
            leaf = leaf.redistribute(mesh, target)
        grad = tuple(
            Partial() if isinstance(p, Replicate) and names[i] in distinct else p
            for i, p in enumerate(target)
        )
        return leaf.to_local(grad_placements=grad)

    local_args = tuple(tree_zip(to_local, a, s) for a, s in zip(args, in_specs))
    out = fn(*local_args)

    def to_dist(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return DTensor.from_local(leaf, mesh, placements(spec, mesh, partial), run_check=False)

    return tree_zip(to_dist, out, out_specs)


def _spec_leaves(specs: Any) -> list:
    if isinstance(specs, P) or specs is None:
        return [] if specs is None else [specs]
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    return [s for v in specs for s in _spec_leaves(v)]


def replicate(x: Optional[torch.Tensor], mesh=None):
    """A plain tensor as a replicated DTensor on the (ambient) mesh;
    DTensors and None as they are."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or x is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def full(x):
    """A DTensor's full value as a plain tensor (other values as they are)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
