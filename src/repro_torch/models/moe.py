"""Mixture-of-Experts layer: top-k token-choice routing with capacity
(counterpart of ``repro.models.moe``).

Without a mesh the block runs once with every expert local.  Under an
ambient mesh with a "model" axis it runs expert-parallel, as the
reference's shard_map branch: tokens sharded over the data axes and
replicated over "model", the expert banks split over "model", each rank
routing its tokens to its local experts only, and the partial outputs
summed over "model" (``models.parallel.moe``).

Dispatch, as in the reference:

  * the router runs in fp32 (fp32 activations into an fp32 router param);
    each token picks its top-k experts and their probabilities are
    renormalised to sum to one;
  * the T·k (token, expert) copies are sorted by expert with a **stable**
    sort, so within an expert the copies keep token order, and a copy's
    position is its rank within its expert;
  * copies at position >= ``capacity`` are dropped, with
    ``capacity = max(int(T·k·capacity_factor / E), 1)`` (``T`` in dropless
    mode: decode and verify, where a token's output must not depend on its
    lane-mates);
  * the kept copies fill an ``[E, capacity, d]`` buffer by index inversion
    (``token_for_slot``; empty slots read a zero row), and the three expert
    products run batched through the quant policy (``"moe"`` class: int8
    with int32 accumulation when it is covered).

Combine: each expert row is weighted by its probability cast to x's dtype
and each token's kept rows are summed in x's dtype in one fixed order —
starting from zero, in ascending expert order (the order of the reference's
scatter-add over the expert-major slots), a dropped copy adding a zero row
last.  No atomics: two calls on the same input are bit-equal on the card.

The three stages are device spans of the ambient tracer
(``repro_torch.obs``): ``moe_dispatch``, ``moe_experts`` and
``moe_combine``; with tracing off they cost nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import _ambient_axis_names
from repro_torch.dist.sharding import DATA_AXES  # noqa: F401  (the reference's name here)
from repro_torch.obs import get_tracer
from repro_torch.quant import get_quant
from .layers import dense_init, mlp_forward
from .parallel import is_dtensor, moe as sharded_moe

# Dispatches since the last ``reset_counts``, by mode, and the (token,
# expert) copies they routed (read by chip_smoke.py).  The dropped copies
# are summed on the device without a host sync; ``dropped_copies`` waits
# for it.
counts = {"capacity": 0, "dropless": 0, "copies_capacity": 0, "copies_dropless": 0}
_dropped: dict = {}
# With ``track_margins`` set, the smallest router margin seen since the last
# reset (a token's k-th largest probability minus its (k+1)-th) is kept on
# the device: a margin near zero is a routing near-tie, where rounding can
# change a token's experts (read by chip_smoke.py's greedy check).
track_margins = False
_min_margin: dict = {}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0
    _dropped.clear()
    _min_margin.clear()


def dropped_copies() -> int:
    """Copies dropped by capacity since the last ``reset_counts``."""
    return int(sum(int(v) for v in _dropped.values()))


def min_router_margin() -> float:
    """The smallest router margin since the last ``reset_counts`` (inf if
    none was tracked)."""
    return min((float(v) for v in _min_margin.values()), default=float("inf"))


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    moe = cfg.moe
    d, e, ff = cfg.d_model, moe.num_experts, moe.d_ff_expert

    def experts(in_d, out_d):
        return torch.stack([dense_init(gen, in_d, out_d, dtype) for _ in range(e)])

    return {
        "router": dense_init(gen, d, e, torch.float32),
        "gate": experts(d, ff),
        "up": experts(d, ff),
        "down": experts(ff, d),
    }


def _moe_block(x, router, gate, up, down, cfg: ModelConfig, expert_offset: int = 0,
               dropless: bool = False):
    """MoE over a token block with the expert slice ``gate/up/down [E_loc,
    ...]`` whose first global id is ``expert_offset``: x [B, S, d] -> this
    slice's part of the output [B, S, d] (the parts of a partition of the
    experts sum to the whole; ``moe_forward`` passes every expert)."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = moe.top_k
    e_loc = gate.shape[0]
    capacity = t if dropless else max(int(t * k * moe.capacity_factor / moe.num_experts), 1)
    dev = x.device

    tracer = get_tracer()
    with tracer.span("moe_dispatch", device=True):
        buf, weight_for_slot, slot_s, order, pos = _dispatch(
            x, router, cfg, expert_offset, e_loc, capacity)
    with tracer.span("moe_experts", device=True):
        quant = get_quant(cfg)
        h = F.silu(quant.dot_batched(buf, gate, "moe"))
        h = h * quant.dot_batched(buf, up, "moe")
        out_buf = quant.dot_batched(h, down, "moe")  # [E, C, d]
    with tracer.span("moe_combine", device=True):
        y = _combine(out_buf, weight_for_slot, slot_s, order, t, k, x.dtype)

    mode = "dropless" if dropless else "capacity"
    counts[mode] += 1
    counts["copies_" + mode] += t * k
    _dropped[dev] = _dropped.get(dev, 0) + (pos >= capacity).sum()
    return y.reshape(b, s, d)


def _dispatch(x, router, cfg: ModelConfig, expert_offset: int, e_loc: int, capacity: int):
    """Route x's tokens and gather the expert buffer [E_loc, capacity, d];
    also each slot's weight, each sorted copy's slot and position, and the
    sort order, which the combine and the counters read."""
    b, s, d = x.shape
    t, k, dev = b * s, cfg.moe.top_k, x.device
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [T, k], descending
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    if track_margins and k < probs.shape[-1]:
        v = torch.topk(probs, k + 1, dim=-1).values
        margin = (v[:, k - 1] - v[:, k]).min()
        _min_margin[dev] = torch.minimum(_min_margin[dev], margin) if dev in _min_margin else margin

    flat_e = top_e.reshape(-1)
    e_s, order = torch.sort(flat_e, stable=True)
    p_s = top_p.reshape(-1)[order]
    t_s = order // k  # copy i of the flat [T, k] list belongs to token i // k
    # Each expert's first copy in the sorted list (no bincount: on CUDA it
    # reads its input's max on the host).
    starts = torch.searchsorted(e_s, torch.arange(cfg.moe.num_experts, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[e_s]
    local_e = e_s - expert_offset
    keep = (pos < capacity) & (local_e >= 0) & (local_e < e_loc)

    # Index inversion: the token that fills (expert, slot), sentinel t for
    # an empty slot (a zero row); dropped copies write the sentinel slot
    # e_loc * capacity, which is cut away.
    n_slots = e_loc * capacity
    slot_s = torch.where(keep, local_e * capacity + pos, n_slots)
    token_for_slot = torch.full((n_slots + 1,), t, dtype=torch.long, device=dev)
    token_for_slot = token_for_slot.scatter(0, slot_s, t_s)[:n_slots]
    weight_for_slot = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev)
    weight_for_slot = weight_for_slot.scatter(0, slot_s, p_s)[:n_slots]

    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    buf = xf_pad[token_for_slot].reshape(e_loc, capacity, d)
    return buf, weight_for_slot, slot_s, order, pos


def _combine(out_buf, weight_for_slot, slot_s, order, t: int, k: int, dtype):
    """Each token's weighted expert rows, summed in ``dtype`` in ascending
    expert order -> [T, d]."""
    n_slots, d = weight_for_slot.shape[0], out_buf.shape[-1]
    weighted = out_buf.reshape(n_slots, d) * weight_for_slot[:, None].to(dtype)
    weighted = torch.cat([weighted, weighted.new_zeros((1, d))])
    # Each token's k slots in ascending expert order (dropped or another
    # slice's: the zero row).
    slot_for_copy = torch.empty_like(slot_s).scatter_(0, order, slot_s).reshape(t, k)
    slot_for_copy = torch.sort(slot_for_copy, dim=-1).values
    y = torch.zeros((t, d), dtype=dtype, device=out_buf.device)
    for j in range(k):
        y = y + weighted[slot_for_copy[:, j]]
    return y


def moe_forward(x: torch.Tensor, params: dict, cfg: ModelConfig, dropless: bool = False) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].

    ``dropless=True`` is the decode-side mode: expert capacity equals the
    token pool, so no copy is dropped and each token's routing is
    independent of its lane-mates.  Train and prefill keep the
    capacity-bounded semantics.

    Under an ambient mesh with a "model" axis (1 x 1 included) the block
    runs expert-parallel, as the reference's shard_map branch: each model
    rank routes its data shard's tokens over its ``E / model`` experts and
    the partial outputs sum over "model" (``models.parallel.moe``).
    """
    if "model" in _ambient_axis_names() and is_dtensor(x):
        def block(x_l, router, gate, up, down, offset):
            return _moe_block(x_l, router, gate, up, down, cfg, expert_offset=offset, dropless=dropless)

        return sharded_moe(block, x, params, cfg).to(x.dtype)
    return _moe_block(
        x, params["router"], params["gate"], params["up"], params["down"], cfg, dropless=dropless
    ).to(x.dtype)


def moe_with_dense_residual(x: torch.Tensor, params: dict, dense_params: dict, cfg: ModelConfig) -> torch.Tensor:
    """Arctic: dense FFN running in parallel with the MoE branch."""
    return moe_forward(x, params, cfg) + mlp_forward(x, dense_params, cfg.mlp_type, get_quant(cfg))
