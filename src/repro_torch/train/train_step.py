"""Training step factory (counterpart of ``repro.train.train_step``): loss
and gradients by ``torch.autograd.grad`` over the param leaves, then the
optimizer, with optional microbatch gradient accumulation and optional
int8 gradient compression with error feedback.

``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
(compressed: ``(params, opt_state, batch, residual) -> (params, opt_state,
residual, metrics)``) returns new params and state and leaves its inputs as
they were.

The ambient tracer (``repro_torch.obs``) gets three device spans:
``forward`` and ``backward`` for each microbatch, and ``optimizer`` around
the update and the gradient norm.

With DTensor params (a mesh) the gradients take their params' placements
(a partial sum over the data axes is reduced there), and the new params
and optimizer state keep the placements of the old, as the reference's
jit ``out_shardings`` do.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import lm_loss
from repro_torch.obs import get_tracer
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.grad_compress import compress_with_feedback, dequantize_int8


def _with_leaves(params: Any, leaves: list) -> Any:
    """``params`` with its tensor leaves replaced, in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def _placed_as(new: Any, old: Any) -> Any:
    """``new``'s DTensor leaves redistributed to the placements of the
    matching leaves of ``old`` (dicts and NamedTuples)."""
    if isinstance(new, dict):
        return {k: _placed_as(v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        return type(new)(*(_placed_as(n, o) for n, o in zip(new, old)))
    if isinstance(new, DTensor) and isinstance(old, DTensor) and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


def value_and_grad(cfg: ModelConfig, params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
    """``lm_loss`` and its gradient, a dict shaped like ``params`` whose
    leaves are in the params' dtypes."""
    tracer = get_tracer()
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        with tracer.span("forward", device=True):
            loss = lm_loss(_with_leaves(params, leaves), cfg, batch)
        # A leaf the loss does not use (the token embedding of an arch fed
        # frame embeddings) gets zeros, as jax.grad gives it.
        with tracer.span("backward", device=True):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    grads = [_placed_as(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), _with_leaves(params, grads)


def make_train_step(
    cfg: ModelConfig,
    optimizer,
    *,
    num_microbatches: int = 1,
    compress_grads: bool = False,
):
    """Returns ``train_step(params, opt_state, batch)`` (with
    ``compress_grads``, ``train_step(params, opt_state, batch, residual)``).
    With microbatches the batch is split along dim 0, the gradients are
    summed in fp32 and averaged (so the optimizer sees fp32 gradients, as in
    the reference)."""

    def compute_grads(params, batch):
        if num_microbatches == 1:
            return value_and_grad(cfg, params, batch)
        if any(v.shape[0] % num_microbatches for v in batch.values()):
            raise ValueError(f"batch does not split into {num_microbatches} microbatches")
        micro = {k: torch.chunk(v, num_microbatches, dim=0) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(num_microbatches):
            loss, g = value_and_grad(cfg, params, {k: parts[i] for k, parts in micro.items()})
            loss_sum = loss_sum + loss
            grads = tree_map(torch.add, grads, g)
        inv = 1.0 / num_microbatches
        return loss_sum * inv, tree_map(lambda g: g * inv, grads)

    def update(params, opt_state, loss, grads):
        with get_tracer().span("optimizer", device=True):
            new_params, new_opt = optimizer.update(grads, opt_state, params)
            new_params, new_opt = _placed_as(new_params, params), _placed_as(new_opt, opt_state)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    if not compress_grads:
        def train_step(params, opt_state, batch):
            return update(params, opt_state, *compute_grads(params, batch))

        return train_step

    def train_step_compressed(params, opt_state, batch, residual):
        # int8 quantization with error feedback: the dequantized values
        # feed the optimizer, the quantization error carries to next step.
        loss, grads = compute_grads(params, batch)
        q, scales, new_residual = compress_with_feedback(grads, residual)
        new_params, new_opt, metrics = update(params, opt_state, loss, tree_map(dequantize_int8, q, scales))
        return new_params, new_opt, new_residual, metrics

    return train_step_compressed


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return lm_loss(params, cfg, batch)

    return eval_step
