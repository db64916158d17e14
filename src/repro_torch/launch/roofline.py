"""Roofline terms of a traced dry-run cell (counterpart of
``repro.launch.roofline``), against one NVIDIA H100 SXM a device:

  compute term    = FLOPs / (devices x 989e12 FLOP/s, bf16 dense)
  memory term     = bytes / (devices x 3.35e12 B/s HBM3)
  collective term = collective bytes / (devices x 50e9 B/s)

The peaks are the H100 SXM datasheet's (``PERF.md`` §2 uses the same two);
50e9 B/s is one 400 Gb/s NDR port a GPU, the link a 16 x 16 mesh of 32 DGX
H100 nodes crosses between nodes.

``CostMode`` is the trace's meter.  It counts DTensor ops and lets them
desugar first (it returns ``NotImplemented`` for them, as ``CommDebugMode``
does), and measures only the local ops each rank runs: FLOPs by ``torch.utils.flop_counter``'s
formulas on local shard shapes (each product counted once, never also at
its global DTensor shape), bytes read and written by every local op, the
result bytes of every functional collective by kind (the reference's
``collective_bytes`` counts XLA's collective result shapes the same way),
and the peak of live local storage.  A dry-run traces one rank of a fake
process group, so totals scale by the device count, as the reference scales
its per-device cost analysis.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

PEAK_FLOPS = 989e12  # bf16 dense, per H100 SXM
HBM_BW = 3.35e12  # bytes/s per H100 SXM
LINK_BW = 50e9  # bytes/s per GPU across nodes (one 400 Gb/s NDR port)
HBM_BYTES = 80e9  # H100 80GB HBM3

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
# Ops that move no data or only describe tensors.
_FREE = {"detach", "view", "_unsafe_view", "reshape", "expand", "t", "transpose", "permute",
         "select", "slice", "unsqueeze", "squeeze", "as_strided", "alias", "split", "unbind",
         "split_with_sizes", "chunk", "diagonal", "wait_tensor", "empty", "empty_like",
         "empty_strided", "lift_fresh", "_to_copy_meta"}


# DTensor's sharding propagation runs ops on global-shaped meta tensors to
# learn output shapes; the meter skips whatever runs inside these methods.
_PROPAGATION = (
    ("torch.distributed.tensor._dispatch", "OpDispatcher", "_propagate_op_sharding_dispatch_slow_path"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator", "propagate"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator", "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator", "_propagate_tensor_meta_non_cached"),
)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """FLOPs, bytes, collective bytes and peak live bytes of the local ops
    run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll_breakdown: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.dtensor_ops = 0  # DTensor dispatches (each costs host time)
        self.local_ops = 0
        self._seen: set = set()
        self._propagating = 0
        self._patched: list = []

    def __enter__(self):
        import importlib

        for module, cls_name, name in _PROPAGATION:
            cls = getattr(importlib.import_module(module), cls_name, None)
            fn = getattr(cls, name, None) if cls is not None else None
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, **k):
                self._propagating += 1
                try:
                    return _fn(*a, **k)
                finally:
                    self._propagating -= 1

            setattr(cls, name, wrapped)
            self._patched.append((cls, name, fn))
        return super().__enter__()

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self._patched):
            setattr(cls, name, fn)
        self._patched.clear()
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops += 0 if self._propagating else 1
            return NotImplemented  # let DTensor desugar into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        self.local_ops += 1
        packet = func._overloadpacket
        name = packet.__name__
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            self.coll_breakdown[kind] = self.coll_breakdown.get(kind, 0) + sum(_nbytes(t) for t in outs)
        elif name not in _FREE:
            ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: max of the three overlappable terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def roofline_fraction(self) -> float:
        """t_compute / step_time: the compute roofline's share if the
        dominant term were perfectly overlapped."""
        return self.t_compute / max(self.step_time, 1e-30)


def analyze_trace(mode: CostMode, chips: int) -> RooflineTerms:
    """Whole-system terms of one rank's trace, scaled by ``chips``."""
    return RooflineTerms(
        flops=mode.flops * chips,
        bytes_accessed=mode.bytes_accessed * chips,
        coll_bytes=float(sum(mode.coll_breakdown.values())) * chips,
        coll_breakdown=dict(mode.coll_breakdown),
        chips=chips,
    )


def model_flops(active_params: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params * tokens
