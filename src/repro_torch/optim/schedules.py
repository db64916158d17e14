"""Learning-rate schedules (counterpart of ``repro.optim.schedules``): pure
functions of the step counter, which may be an int, a float or a tensor;
each returns an fp32 tensor."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def schedule(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def linear_warmup_constant(peak_lr: float, warmup_steps: int):
    def schedule(step):
        step = _step(step)
        return peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)

    return schedule
