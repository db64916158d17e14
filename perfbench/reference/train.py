"""Plain PyTorch reference of the benchmark's training steps: next-token
cross entropy of ``model.forward`` in float32, its gradient by autograd,
and AdamW as the training configuration states it (``traffic/*.json``,
``"optimizer"``): fp32 moments, bias correction, eps outside the square
root, decoupled weight decay on every leaf, the learning rate of a linear
warm-up then cosine schedule, and parameters stored in the served dtype,
each update cast to it before it is added (no fp32 master copy).  Rows are
run one at a time and their gradients summed, so a batch fits."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        elif v is not None:
            out[name] = v
    return out


def layout(tree: dict) -> dict:
    """The nested keys of ``tree``, its tensor leaves replaced by True."""
    return {k: layout(v) if isinstance(v, dict) else (None if v is None else True) for k, v in tree.items()}


def unflatten(flat: dict, like: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in like.items():
        name = f"{prefix}{k}"
        out[k] = unflatten(flat, v, name + ".") if isinstance(v, dict) else (None if v is None else flat[name])
    return out


def learning_rate(step: int, opt: dict) -> float:
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    progress = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * progress)))


def loss_and_grads(weights: dict, m: dict, tokens, labels) -> tuple[float, dict]:
    """Mean loss over every label of [B, S] and the gradient of each leaf."""
    flat = {k: v.float().requires_grad_() for k, v in flatten(weights).items()}
    nested = unflatten(flat, weights)
    total = 0.0
    for b in range(tokens.shape[0]):
        logits = model.forward(nested, m, tokens[b].long())
        row = F.cross_entropy(logits, labels[b].long(), reduction="sum") / labels.numel()
        row.backward()
        total += float(row.detach())
        del logits, row
    return total, {k: v.grad for k, v in flat.items()}


def run_steps(weights: dict, m: dict, batches: list, opt: dict) -> dict:
    """``len(batches)`` AdamW steps from ``weights``; the losses, each
    leaf's gradient at step 1 (``grad_t``) and its norm (``grad``), and the
    norm of each leaf's change over the steps (``change``)."""
    params = {k: v.clone() for k, v in flatten(weights).items()}
    start = {k: v.clone() for k, v in params.items()}
    mom = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    var = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], {}
    for t, (tokens, labels) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(unflatten(params, weights), m, tokens, labels)
        losses.append(loss)
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            first = grads
        lr = learning_rate(t, opt)
        with torch.no_grad():
            for k, g in grads.items():
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                var[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (mom[k] / (1 - b1 ** t)) / (torch.sqrt(var[k] / (1 - b2 ** t)) + eps)
                delta = delta + wd * params[k].float()
                params[k] = params[k] + (-lr * delta).to(params[k].dtype)
        del grads
    change = {k: float(torch.linalg.vector_norm(params[k].float() - start[k].float())) for k in params}
    return {"losses": losses, "grad": grad_norms, "change": change, "grad_t": first}
