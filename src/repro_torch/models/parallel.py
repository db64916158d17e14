"""The model under DTensor placements: the islands where it runs on local
shards.

Parameters and caches enter the model as DTensors (``repro_torch.dist``),
and outside the islands below PyTorch's sharding propagation plays GSPMD's
part: norms, residual adds, the Megatron-SP ``constrain`` of the layer
carry, the logits product, the loss and the optimizer run on DTensors, and
every redistribution (SP all-gather, partial-sum reduce-scatter, ZeRO
gathers) is a DTensor collective.  Each function here is an island
(``dist.collectives.local_island``, the reference's ``shard_map``) for a
sub-layer that must see local tensors or whose layout is explicit:

  * ``embed``: vocab-parallel lookup (rows of other ranks' vocab are zero),
    a partial sum over "model";
  * ``attention``: projections, RoPE, KV-cache writes at per-slot offsets
    and the attention kernels (their wrappers read ``data_ptr()``), on the
    rank's heads: column-parallel wq/wk/wv, row-parallel wo, a partial sum
    over "model".  A KV head shared by several ranks (``model % kv_heads ==
    0``) is read from replicated wk/wv, and a cache replicated over "model"
    holds on each rank the heads that rank reads;
  * ``mlp``: column-parallel gate/up, row-parallel down, a partial sum;

    under an int8 policy for their class these two hand their products the
    layout of the shards (``quant.split_weights``): each product takes the
    whole operands' scales, and the row-parallel one sums its int32
    accumulator over "model", so the island's output is replicated there
    and equals the unsharded one, as the reference's GSPMD gives it;
  * ``moe``: expert parallelism (the reference's shard_map branch);
  * ``replicated``: the recurrent blocks (Mamba2, mLSTM, sLSTM), whose
    fused in-projections do not split by rank; their weights are gathered
    over "model" and each rank computes the whole block.

Without a "model" axis of size > 1 every island runs the single-device code
on its batch shard; on a 1 x 1 mesh every placement is ``Replicate`` and
the tensors stay DTensors all the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import P, local_island, mesh_sizes
from repro_torch.dist.sharding import DATA_AXES, _fit, spec_of
from repro_torch.quant import Quant, get_quant
from repro_torch.quant.policy import split_weights
from repro_torch.quant.quantize import Split


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _model(mesh) -> tuple[int, int]:
    """(size, this rank's coordinate) of the "model" axis (1, 0 if none)."""
    if "model" not in mesh.mesh_dim_names:
        return 1, 0
    return mesh.size(mesh.mesh_dim_names.index("model")), mesh.get_local_rank("model")


def batch_spec(mesh, x) -> Optional[P]:
    """Batch (dim 0) over the data axes (fitted), the rest replicated."""
    if x is None or not isinstance(x, torch.Tensor):
        return None
    if x.ndim == 0:
        return P()
    sizes = mesh_sizes(mesh)
    entry = _fit(tuple(a for a in DATA_AXES if sizes.get(a, 0) > 1), x.shape[0], sizes)
    return P(entry, *([None] * (x.ndim - 1)))


def _last(x, axis="model") -> P:
    return P(*([None] * (x.ndim - 1)), axis)


def _first(x, axis="model") -> P:
    return P(axis, *([None] * (x.ndim - 1)))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a vocab-sharded table gives each rank's rows and
    zeros elsewhere, summed over "model" (exact: one rank adds a row)."""
    mesh = table.device_mesh
    m, r = _model(mesh)
    tspec = spec_of(table)
    bspec = batch_spec(mesh, tokens)
    sharded = m > 1 and tspec[0] == "model"
    if sharded:
        rows = table.shape[0] // m

        def body(t, ids):
            local = ids - r * rows
            hit = (local >= 0) & (local < rows)
            return t[local.clamp(0, rows - 1)] * hit[..., None].to(t.dtype)
    else:
        def body(t, ids):
            return t[ids]

    return local_island(body, (table, tokens), (tspec, bspec), P(bspec[0], None, None), mesh=mesh,
                        partial=("model",) if sharded else ())


def _head_layout(cfg: ModelConfig, m: int) -> tuple[bool, bool]:
    """(q heads sharded, kv heads sharded) over a model axis of ``m``: the
    rank's q heads must fall on whole KV heads it holds, or on one KV head
    shared by ``m / kv_heads`` ranks; otherwise attention is replicated."""
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    q = m > 1 and h % m == 0 and (hkv % m == 0 or m % hkv == 0)
    return q, q and hkv % m == 0


def attention(body, x, params: dict, cfg: ModelConfig, positions, cache=None, write_pos=None):
    """``body(x, params, local_cfg, positions, cache, write_pos) -> o`` on
    the rank's heads; the result is a partial sum over "model" where heads
    are sharded (replicated under an int8 policy for attention, whose wo
    product sums over "model").  The cache keeps its own placements (it is
    written in place)."""
    mesh = x.device_mesh
    m, r = _model(mesh)
    q_sh, kv_sh = _head_layout(cfg, m)
    int8 = q_sh and get_quant(cfg).active("attention")
    hd = cfg.resolved_head_dim
    specs = {}
    for name, leaf in params.items():
        if name in ("wq", "bq") and q_sh or name in ("wk", "wv", "bk", "bv") and kv_sh:
            specs[name] = _last(leaf)
        elif name == "wo" and q_sh:
            specs[name] = _first(leaf)
        else:
            specs[name] = P()
    hq = cfg.num_heads // m if q_sh else cfg.num_heads
    if q_sh and not kv_sh:  # one KV head shared by m / kv_heads ranks
        nkv, kv_lo = 1, r * hq // (cfg.num_heads // cfg.num_kv_heads)
    else:
        nkv, kv_lo = (cfg.num_kv_heads // m if kv_sh else cfg.num_kv_heads), None
    lcfg = dataclasses.replace(cfg, num_heads=hq, num_kv_heads=nkv, head_dim=hd)

    def local(x_l, p_l, pos_l, cache_l, wp_l):
        whole = p_l
        if kv_lo is not None:
            cols = slice(kv_lo * hd, (kv_lo + 1) * hd)
            p_l = {k: (v[..., cols] if k in ("wk", "wv", "bk", "bv") else v) for k, v in p_l.items()}
            if cache_l is not None:
                cache_l = type(cache_l)(*(
                    leaf[:, :, kv_lo:kv_lo + 1] if leaf.dim() >= 3 else leaf for leaf in cache_l
                ))
        splits = []
        if int8:
            group = mesh.get_group("model")
            splits = [(p_l["wo"], Split("contraction", group)), (p_l["wq"], Split("columns", group))]
            splits += [(p_l[k], Split("columns", group) if kv_sh else Split("columns", whole=whole[k]))
                       for k in ("wk", "wv")]
        with split_weights(splits):
            return body(x_l, p_l, lcfg, pos_l, cache_l, wp_l)

    cache_specs = None if cache is None else tuple(spec_of(leaf) for leaf in cache)
    bspec = batch_spec(mesh, x)
    return local_island(
        local,
        (x, params, positions, cache, write_pos),
        (bspec, specs, batch_spec(mesh, positions), cache_specs, batch_spec(mesh, write_pos)),
        bspec, mesh=mesh, partial=("model",) if q_sh and not int8 else (),
        varying=("model",) if q_sh else (),
    )


def mlp(body, x, params: dict, quant: Quant):
    """``body(x, params)`` with column-parallel gate/up and row-parallel
    down where d_ff divides "model"; a partial sum over it then, or, under
    ``quant``'s int8 for "mlp", replicated (down sums over "model")."""
    mesh = x.device_mesh
    m, _ = _model(mesh)
    sharded = m > 1 and params["up"].shape[-1] % m == 0
    int8 = sharded and quant.active("mlp")
    specs = {
        name: (_first(leaf) if name == "down" else _last(leaf)) if sharded else P()
        for name, leaf in params.items()
    }

    def local(x_l, p_l):
        splits = []
        if int8:
            group = mesh.get_group("model")
            splits = [(w, Split("contraction" if name == "down" else "columns", group)) for name, w in p_l.items()]
        with split_weights(splits):
            return body(x_l, p_l)

    bspec = batch_spec(mesh, x)
    return local_island(local, (x, params), (bspec, specs), bspec, mesh=mesh,
                        partial=("model",) if sharded and not int8 else (),
                        varying=("model",) if sharded else ())


def moe(block, x, params: dict, cfg: ModelConfig):
    """The reference's expert-parallel branch: each model rank runs
    ``block(x, router, gate, up, down, expert_offset)`` on its ``E / model``
    experts; the expert weights are gathered over "data" along the ff dim
    where that divides (ZeRO-3), and the partial outputs sum over "model"."""
    mesh = x.device_mesh
    m, r = _model(mesh)
    e = cfg.moe.num_experts
    if e % m:
        raise ValueError(f"num_experts={e} not divisible by model axis {m}")
    e_loc = e // m
    sizes = mesh_sizes(mesh)
    zero3 = sizes.get("data", 1) > 1 and cfg.moe.d_ff_expert % sizes["data"] == 0
    ffd = "data" if zero3 else None
    exp = "model" if m > 1 else None
    bspec = batch_spec(mesh, x)

    def local(x_l, router, gate, up, down):
        if zero3:  # ZeRO-3: gather the ff dim just in time
            import torch.distributed._functional_collectives as funcol

            gather = getattr(funcol, "all_gather_single_autograd", None) or funcol.all_gather_tensor_autograd
            group = mesh.get_group("data")
            gate, up, down = gather(gate, 2, group), gather(up, 2, group), gather(down, 1, group)
        return block(x_l, router, gate, up, down, r * e_loc)

    return local_island(
        local,
        (x, params["router"], params["gate"], params["up"], params["down"]),
        (bspec, P(), P(exp, None, ffd), P(exp, None, ffd), P(exp, ffd, None)),
        bspec, mesh=mesh, partial=("model",) if m > 1 else (),
    )


def replicated(body, x, params: dict, state: Any = None):
    """``body(x, params, state)`` with every weight and state leaf gathered
    over "model": each rank computes the whole block on its batch shard.
    Returns what ``body`` returns, its tensors batch-sharded; a returned
    state takes the placements of ``state``'s leaves."""
    mesh = x.device_mesh
    bspec = batch_spec(mesh, x)
    pspecs = {k: P() for k in params}
    sspec = None if state is None else type(state)(*(batch_spec(mesh, leaf) for leaf in state))
    if state is None:
        return local_island(lambda a, p, _s: body(a, p, None), (x, params, None), (bspec, pspecs, None),
                            bspec, mesh=mesh)
    y, new = local_island(body, (x, params, state), (bspec, pspecs, sspec), (bspec, sspec), mesh=mesh)
    return y, type(new)(*(
        n.redistribute(mesh, o.placements) if isinstance(o, DTensor) else n for n, o in zip(new, state)
    ))


def logits(x, head):
    """``x @ head`` (``head [d, V]``), vocab-parallel where ``head`` is
    vocab-sharded: each rank's logits columns."""
    mesh = x.device_mesh
    hspec = spec_of(head)
    bspec = batch_spec(mesh, x)
    return local_island(lambda a, h: a @ h, (x, head), (bspec, hspec),
                        P(bspec[0], None, hspec[-1]), mesh=mesh)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over a vocab split
    across a process group (Megatron's vocab-parallel cross entropy): the
    max and the two sums are all-reduced; the gradient is the rank's
    columns of ``softmax - onehot``, with no collective."""

    @staticmethod
    def forward(ctx, lf, labels, lo, group):
        import torch.distributed._functional_collectives as funcol

        m = funcol.all_reduce(lf.amax(dim=-1), "max", group)
        e = torch.exp(lf - m[..., None])
        s = funcol.all_reduce(e.sum(dim=-1), "sum", group)
        local = labels.long() - lo
        hit = (local >= 0) & (local < lf.shape[-1])
        idx = local.clamp(0, lf.shape[-1] - 1)
        tgt = torch.gather(lf, -1, idx[..., None])[..., 0] * hit
        tgt = funcol.all_reduce(tgt, "sum", group)
        ctx.save_for_backward(e, s, idx, hit)
        return torch.log(s) + m - tgt

    @staticmethod
    def backward(ctx, g):
        e, s, idx, hit = ctx.saved_tensors
        grad = e / s[..., None]
        grad = grad.scatter_add(-1, idx[..., None], -hit[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def token_nll(logits_: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood [B, S] of fp32 logits at
    ``labels`` (negative labels read column 0; the caller masks them).
    Unsharded vocab: ``log_softmax`` and a gather, as ``lm_loss`` computes
    it without a mesh."""
    mesh = logits_.device_mesh
    m, r = _model(mesh)
    lspec = spec_of(logits_)
    bspec = batch_spec(mesh, labels)
    sharded = m > 1 and lspec[-1] == "model"

    def local(lg, lab):
        lf = lg.float()
        if sharded:
            return _VocabParallelNLL.apply(lf, lab.clamp(min=0), r * lf.shape[-1], mesh.get_group("model"))
        logp = torch.log_softmax(lf, dim=-1)
        return -torch.gather(logp, -1, lab.clamp(min=0).long()[..., None])[..., 0]

    return local_island(local, (logits_, labels), (P(bspec[0], None, lspec[-1]), bspec), bspec,
                        mesh=mesh)
