"""FSA kernel programming model (paper §5) — the NKI-inspired Python API.

Faithful to the paper's Listing 1/2 surface:

  * three type-safe tensor classes scoped to a memory space — ``MTile``
    (main memory), ``STile`` (scratchpad SRAM), ``ATile`` (accumulation
    SRAM) — supporting ``shape``, ``dtype``, ``split`` and ``to_numpy``;
  * one Python function per FSA instruction (``load_tile``,
    ``store_tile``, ``load_stationary``, ``attn_score``, ``attn_value``,
    ``reciprocal``, ``attn_lse_norm``);
  * an ``@kernel`` decorator that JIT-packages the traced instruction
    stream into an ``FSAProgram`` and executes it on the ``FSADevice``
    simulator (the paper targets a Verilator RTL simulation; our device
    model reproduces its arithmetic and cycle counts — see fsa_sim.py).

``fsa_flash.py`` writes the paper's Listing 2 FlashAttention kernel on top
of this API.  A numpy copy of ``repro.core.fsa_kernel_api``, held equal to
it by ``tests/test_torch_fsa.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Optional

import numpy as np

from .fsa_sim import FSADevice, FSAProgram

__all__ = [
    "MTile", "STile", "ATile",
    "alloc_mem", "alloc_spad", "alloc_accum",
    "load_tile", "store_tile", "load_stationary",
    "attn_score", "attn_value", "reciprocal", "attn_lse_norm",
    "kernel", "KernelResult",
]

_state = threading.local()


def _ctx() -> "_KernelContext":
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        raise RuntimeError("FSA instructions must run inside an @fsa.kernel function")
    return ctx


class _KernelContext:
    def __init__(self, device: FSADevice):
        self.device = device
        self.program = FSAProgram()
        self.counter = 0

    def fresh(self, prefix: str) -> str:
        self.counter += 1
        return f"{prefix}_{self.counter}"

    def emit(self, op: str, **operands) -> None:
        """Record the instruction and execute it eagerly on the device."""
        self.program.emit(op, **operands)


@dataclasses.dataclass
class _Tile:
    key: str
    shape: tuple
    dtype: np.dtype
    space: str

    def split(self, size: int, dim: int = -1) -> list:
        """Tile views along one dimension (paper Listing 2 usage)."""
        dim = dim % len(self.shape)
        n = self.shape[dim]
        assert n % size == 0, (n, size)
        out = []
        for i in range(n // size):
            sub = dataclasses.replace(
                self,
                key=f"{self.key}[{dim}:{i*size}:{(i+1)*size}]",
                shape=tuple(size if d == dim else s for d, s in enumerate(self.shape)),
            )
            sub._parent = self  # type: ignore[attr-defined]
            sub._slice = (dim, i * size, (i + 1) * size)  # type: ignore[attr-defined]
            out.append(sub)
        return out

    # view plumbing -----------------------------------------------------------
    _parent: Optional["_Tile"] = dataclasses.field(default=None, repr=False)
    _slice: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def _read(self, mem: dict) -> np.ndarray:
        if self._parent is None:
            return mem[self.key]
        base = self._parent._read(mem)
        dim, lo, hi = self._slice
        idx = tuple(slice(lo, hi) if d == dim else slice(None) for d in range(base.ndim))
        return base[idx]

    def _write(self, mem: dict, value: np.ndarray) -> None:
        if self._parent is None:
            mem[self.key] = value
            return
        base = self._parent._read(mem)
        dim, lo, hi = self._slice
        idx = tuple(slice(lo, hi) if d == dim else slice(None) for d in range(base.ndim))
        base[idx] = value


class MTile(_Tile):
    def to_numpy(self) -> np.ndarray:
        return np.asarray(self._read(_ctx().device.main))


class STile(_Tile):
    pass


class ATile(_Tile):
    pass


# -- allocation ----------------------------------------------------------------

def alloc_mem(shape, dtype=np.float16, data: Optional[np.ndarray] = None, name=None) -> MTile:
    ctx = _ctx()
    key = name or ctx.fresh("m")
    ctx.device.alloc("main", key, tuple(shape), dtype)
    if data is not None:
        assert tuple(data.shape) == tuple(shape), (data.shape, shape)
        ctx.device.main[key] = np.asarray(data, dtype=dtype)
    return MTile(key, tuple(shape), np.dtype(dtype), "main")


def alloc_spad(shape, dtype=np.float16, name=None) -> STile:
    ctx = _ctx()
    key = name or ctx.fresh("s")
    ctx.device.alloc("spad", key, tuple(shape), dtype)
    return STile(key, tuple(shape), np.dtype(dtype), "spad")


def alloc_accum(shape, dtype=np.float32, name=None) -> ATile:
    ctx = _ctx()
    key = name or ctx.fresh("a")
    ctx.device.alloc("accum", key, tuple(shape), dtype)
    return ATile(key, tuple(shape), np.dtype(dtype), "accum")


# -- DMA instructions -----------------------------------------------------------

def load_tile(src: MTile, dst: STile) -> None:
    assert isinstance(src, MTile) and isinstance(dst, STile), "load_tile: MTile -> STile"
    ctx = _ctx()
    ctx.emit("load_tile", src=src.key, dst=dst.key)
    dst._write(ctx.device.spad, src._read(ctx.device.main).astype(np.float16))


def store_tile(src: ATile, dst: MTile) -> None:
    assert isinstance(src, ATile) and isinstance(dst, MTile), "store_tile: ATile -> MTile"
    ctx = _ctx()
    ctx.emit("store_tile", src=src.key, dst=dst.key)
    dst._write(ctx.device.main, src._read(ctx.device.accum).astype(dst.dtype))


# -- compute instructions ---------------------------------------------------------

def _advance(op: str) -> None:
    dev = _ctx().device
    dev.compute_cycles += dev.stagger_cycles(op)
    dev.cycles = dev.compute_cycles
    dev.instr_count += 1


def load_stationary(tile: STile, transpose: bool = False, reset_stats: bool = True) -> None:
    assert isinstance(tile, STile)
    ctx = _ctx()
    ctx.emit("load_stationary", tile=tile.key, transpose=transpose, reset_stats=reset_stats)
    t = tile._read(ctx.device.spad).astype(np.float16)
    ctx.device.stationary = t.T if transpose else t
    if reset_stats:
        ctx.device.old_m = np.full(
            (ctx.device.stationary.shape[1],), -np.inf, np.float32
        )
    _advance("load_stationary")


def attn_score(k: STile, l: ATile, scale: float) -> None:
    assert isinstance(k, STile) and isinstance(l, ATile)
    ctx = _ctx()
    ctx.emit("attn_score", k=k.key, l=l.key, scale=scale)
    dev = ctx.device
    # Route through the device op on materialized views.
    dev.spad["__k"] = k._read(dev.spad)
    dev.accum["__l"] = l._read(dev.accum)
    dev._op_attn_score(k="__k", l="__l", scale=scale)
    l._write(dev.accum, dev.accum.pop("__l"))
    dev.spad.pop("__k")
    _advance("attn_score")


def attn_value(v: STile, o: ATile) -> None:
    assert isinstance(v, STile) and isinstance(o, ATile)
    ctx = _ctx()
    ctx.emit("attn_value", v=v.key, o=o.key)
    dev = ctx.device
    dev.spad["__v"] = v._read(dev.spad)
    dev.accum["__o"] = o._read(dev.accum)
    dev._op_attn_value(v="__v", o="__o")
    o._write(dev.accum, dev.accum.pop("__o"))
    dev.spad.pop("__v")
    _advance("attn_value")


def reciprocal(l: ATile) -> None:
    assert isinstance(l, ATile)
    ctx = _ctx()
    ctx.emit("reciprocal", l=l.key)
    dev = ctx.device
    dev.accum["__l"] = l._read(dev.accum)
    dev._op_reciprocal(l="__l")
    dev.accum.pop("__l")
    _advance("reciprocal")


def attn_lse_norm(o: ATile) -> None:
    assert isinstance(o, ATile)
    ctx = _ctx()
    ctx.emit("attn_lse_norm", o=o.key)
    dev = ctx.device
    dev.accum["__o"] = o._read(dev.accum)
    dev._op_attn_lse_norm(o="__o")
    o._write(dev.accum, dev.accum.pop("__o"))
    _advance("attn_lse_norm")


# -- the JIT decorator -------------------------------------------------------------

@dataclasses.dataclass
class KernelResult:
    output: np.ndarray
    cycles: int
    instr_count: int
    program: FSAProgram
    device: FSADevice

    def seconds(self) -> float:
        return self.device.seconds()


def kernel(device: str = "fsa_sim", array_n: int = 128, **dev_kwargs) -> Callable:
    """Compile+run a Python FSA kernel on the device simulator.

    The decorated function receives/returns tiles; numpy array arguments are
    auto-wrapped as MTiles.  Returns a KernelResult with the output array,
    the instruction program and the cycle count.
    """

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*arrays: np.ndarray) -> KernelResult:
            dev = FSADevice(array_n=array_n, **dev_kwargs)
            ctx = _KernelContext(dev)
            _state.ctx = ctx
            try:
                tiles = [
                    alloc_mem(a.shape, np.float16, data=np.asarray(a)) for a in arrays
                ]
                out = fn(*tiles)
                result = out.to_numpy() if isinstance(out, MTile) else out
            finally:
                _state.ctx = None
            return KernelResult(
                output=result,
                cycles=dev.cycles,
                instr_count=dev.instr_count,
                program=ctx.program,
                device=dev,
            )

        return wrapper

    return deco
