"""AdamW and Adafactor (counterpart of ``repro.optim.adamw``), written as the
reference writes them and not as ``torch.optim``: functions from (grads,
state, params) to (new params, new state) over the params dict.

AdamW: b2 = 0.95, eps outside the square root, weight decay added to the
update of every leaf, fp32 ``m`` and ``v`` that mirror the params, and each
update cast to the param's dtype before it is added (bf16 params keep no
fp32 master copy).  Adafactor factors the second moment of every leaf of
two or more dims.  ``None`` leaves (non-parametric norms) stay ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts (``None`` stays
    ``None``); ``rest`` are dicts of at least the same structure, whose
    values at those leaves go to ``fn`` as they are (a leaf's dict of
    optimizer statistics, say)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Tensor leaves of nested dicts, in key order, ``None`` left out."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def _unzip(tree: Any, n: int) -> tuple:
    """A tree whose leaves are n-tuples as n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return AdamWState(step=step, m=tree_map(zeros, params), v=tree_map(zeros, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

        def upd(g, m, v, p):
            g = g.float()
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return p + (-lr * delta).to(p.dtype), m_new, v_new

        out = tree_map(upd, grads, state.m, state.v, params)
        new_params, m, v = _unzip(out, 3)
        return new_params, AdamWState(step=step, m=m, v=v)


class AdafactorState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    # Per-leaf dicts: either {"r", "c"} (factored) or {"v"} (unfactored).
    stats: Any


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    decay: float = 0.8  # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params) -> AdafactorState:
        def stat(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            if p.ndim >= 2:
                return {"r": zeros(p.shape[:-1]), "c": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return AdafactorState(step=step, stats=tree_map(stat, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params):
        step = state.step + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-self.decay)
        lr = self._lr(step)

        def upd(g, p, s):
            g = g.float()
            g2 = g * g + self.eps
            if g.ndim >= 2:
                r = beta2 * s["r"] + (1 - beta2) * g2.mean(dim=-1)
                c = beta2 * s["c"] + (1 - beta2) * g2.mean(dim=-2)
                r_norm = r / torch.clamp(r.mean(dim=-1, keepdim=True), min=self.eps)
                v_hat = r_norm[..., None] * c[..., None, :]
                u = g / torch.sqrt(v_hat + self.eps)
                s_new = {"r": r, "c": c}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g / torch.sqrt(v + self.eps)
                s_new = {"v": v}
            # Update clipping (Adafactor's RMS clip).
            rms = torch.sqrt(torch.mean(u * u) + self.eps)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), s_new

        out = tree_map(upd, grads, params, state.stats)
        new_params, stats = _unzip(out, 2)
        return new_params, AdafactorState(step=step, stats=stats)


def make_optimizer(name: str, lr, **kw):
    if name == "adamw":
        return AdamW(lr=lr, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr, **kw)
    raise ValueError(name)
