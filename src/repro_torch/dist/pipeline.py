"""GPipe-style pipeline parallelism over the "pod" mesh axis (counterpart
of ``repro.dist.pipeline``).

``pipelined_apply`` runs a stack of identical stages (stage s owns
``stage_params[s]``) over a batch split into microbatches.  Under an
ambient mesh (``dist.collectives.set_mesh``) with a "pod" axis of size
``num_stages`` it runs as a pipeline: each "pod" rank holds one stage's
weights, activations move one stage a tick by point-to-point ops on the
"pod" group (the reference's ``ppermute``), and the schedule drains in
``num_microbatches + num_stages - 1`` ticks (the GPipe bubble).  Off the
mesh, or where the mesh does not match, it runs the sequential schedule,
which gives the same numbers.

Where the reference is one SPMD program, every stage here computes only
the ticks that carry one of its microbatches: a stage idles through the
bubble instead of replaying the last microbatch, and sends and receives
only what a later stage consumes, so no idle result can reach the outputs
or the gradients.  Under autograd every rank threads its exchanges through
one chain (``_Exchange``'s ``order`` tensor), so each rank's backward runs
them in reverse tick order, and each one's backward is the reverse shift:
a received activation's gradient goes back to the stage that sent it.
Tensors that enter replicated (``x``, plain ``stage_params`` leaves) get
their gradients summed over "pod", as the transpose of the reference's
replicated inputs; the outputs are summed to every rank (the reference's
``psum``: the other stages add zeros), and their gradient is each rank's
own.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .collectives import get_mesh

AXIS = "pod"


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples (``None``
    stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _stage_slice(stage_params: Any, i: int) -> Any:
    return _tree_map(lambda w: w[i], stage_params)


def _sequential(stage_fn, stage_params, x, num_stages):
    for i in range(num_stages):
        x = stage_fn(_stage_slice(stage_params, i), x)
    return x


def pipelined_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # tree; every leaf has leading dim num_stages
    x: torch.Tensor,  # [B, ...] activations entering stage 0
    *,
    num_stages: int,
    num_microbatches: int,
) -> torch.Tensor:
    """Apply ``num_stages`` stages in sequence, pipelined over "pod".

    ``stage_fn(w, x)`` must keep the shape and dtype of ``x``.  Pipelined,
    ``x`` and the result are plain tensors, the same on every rank, and a
    ``stage_params`` leaf is a plain tensor (every rank holds all stages) or
    a DTensor on the mesh (each rank reads its "pod" shard).
    """
    mesh = get_mesh()
    pipelined = (
        mesh is not None
        and AXIS in mesh.mesh_dim_names
        and mesh.size(mesh.mesh_dim_names.index(AXIS)) == num_stages
        and num_stages > 1
        and x.shape[0] % num_microbatches == 0
    )
    if not pipelined:
        return _sequential(stage_fn, stage_params, x, num_stages)
    return _pipelined(stage_fn, stage_params, x, mesh, num_stages, num_microbatches)


class _Enter(torch.autograd.Function):
    """Starts the exchange chain's ``order`` tensor and passes every input
    of the stages through, so that a backward asked for any of them runs
    the whole chain.  ``x`` and the plain stacked weights (``stacked[i]``
    true: this rank takes its row) entered replicated: their gradients are
    summed over the group (a weight's rows of other stages are zero here).
    A DTensor's local row passes as it is."""

    @staticmethod
    def forward(ctx, order, stage, group, stacked, x, *leaves):
        ctx.stage, ctx.group, ctx.summed = stage, group, (True, *stacked)
        ctx.likes = [(t.shape, t.dtype, t.device) for t in (x, *leaves)]
        rows = (w[stage] if whole else w.view_as(w) for w, whole in zip(leaves, stacked))
        return (order.clone(), x.view_as(x), *rows)

    @staticmethod
    def backward(ctx, g_order, *g_local):
        grads = []
        for i, (g, (shape, dtype, device), need) in enumerate(zip(g_local, ctx.likes, ctx.needs_input_grad[4:])):
            if not need or not ctx.summed[i]:  # a DTensor's local row: its own gradient
                grads.append(g if need else None)
                continue
            full = torch.zeros(shape, dtype=dtype, device=device)
            if g is not None:
                if i == 0:
                    full.copy_(g)
                else:  # a stacked weight: this rank's row, zeros elsewhere
                    full[ctx.stage] = g
            dist.all_reduce(full, group=ctx.group)
            grads.append(full)
        return (g_order, None, None, None, *grads)


class _Exchange(torch.autograd.Function):
    """One tick's shift to the next stage: sends ``y`` (or nothing) to the
    next rank and returns what the previous rank sent (or None).  The
    backward is the reverse shift.  ``order`` chains the ticks."""

    @staticmethod
    def forward(ctx, order, y, recv_like, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group, ctx.recv_like = prev, nxt, group, recv_like
        ctx.y_like = None if y is None else (y.shape, y.dtype, y.device)
        recv = None if recv_like is None else torch.empty(recv_like[0], dtype=recv_like[1], device=recv_like[2])
        ops = []
        if y is not None:
            ops.append(dist.P2POp(dist.isend, y.detach().contiguous(), nxt, group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, prev, group))
        _run(ops)
        return order.clone(), recv

    @staticmethod
    def backward(ctx, g_order, g_recv):
        ops, g_y = [], None
        if ctx.recv_like is not None:
            if g_recv is None:
                shape, dtype, device = ctx.recv_like
                g_recv = torch.zeros(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.isend, g_recv.contiguous(), ctx.prev, ctx.group))
        if ctx.y_like is not None:
            shape, dtype, device = ctx.y_like
            g_y = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, g_y, ctx.nxt, ctx.group))
        _run(ops)
        return g_order, g_y, None, None, None, None


class _Leave(torch.autograd.Function):
    """The outputs summed over the group (the reference's psum: the stages
    that hold none add zeros); each rank's gradient is its own.  Ends the
    exchange chain."""

    @staticmethod
    def forward(ctx, order, acc, group):
        ctx.order_like = (order.dtype, order.device)
        out = acc.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g_out):
        dtype, device = ctx.order_like
        return torch.zeros((), dtype=dtype, device=device), g_out, None


def _run(ops: list) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _own_stage(leaf, mesh):
    """A DTensor leaf's "pod" shard (redistributed to ``Shard(0)`` over
    "pod", replicated over the other axes, as the reference's in_specs)."""
    target = tuple(Shard(0) if n == AXIS else Replicate() for n in mesh.mesh_dim_names)
    if tuple(leaf.placements) != target:
        leaf = leaf.redistribute(mesh, target)
    return leaf.to_local()[0]


def _pipelined(stage_fn, stage_params, x, mesh, num_stages: int, num_microbatches: int):
    group = mesh.get_group(AXIS)
    stage = mesh.get_local_rank(AXIS)
    ranks = dist.get_process_group_ranks(group)
    prev = ranks[stage - 1] if stage > 0 else None
    nxt = ranks[stage + 1] if stage < num_stages - 1 else None
    m = num_microbatches
    x_mb = x.reshape(m, x.shape[0] // m, *x.shape[1:])

    leaves = _leaves(stage_params)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in [x, *leaves])
    order = torch.zeros((), device=x.device, requires_grad=grad)
    stacked = tuple(not isinstance(w, DTensor) for w in leaves)
    local = [w if whole else _own_stage(w, mesh) for w, whole in zip(leaves, stacked)]
    order, x_mb, *rows = _Enter.apply(order, stage, group, stacked, x_mb, *local)
    own = iter(rows)
    w = _tree_map(lambda _leaf: next(own), stage_params)

    outs, recv = [], None
    for t in range(m + num_stages - 1):
        mb = t - stage  # the microbatch this stage holds at tick t
        y = None
        if 0 <= mb < m:
            y = stage_fn(w, x_mb[mb] if stage == 0 else recv)
            if nxt is None:
                outs.append(y)
        # The next stage takes y at tick t + 1; this one takes the previous
        # stage's microbatch t - (stage - 1) where that exists.
        send = y if nxt is not None else None
        takes = prev is not None and 0 <= t - (stage - 1) < m
        recv_like = (x_mb.shape[1:], x_mb.dtype, x_mb.device) if takes else None
        order, recv = _Exchange.apply(order, send, recv_like, prev, nxt, group)
    acc = torch.stack(outs) if outs else torch.zeros_like(x_mb)
    out = _Leave.apply(order, acc, group)
    return out.reshape(x.shape)
