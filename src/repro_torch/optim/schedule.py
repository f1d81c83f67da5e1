"""Learning-rate schedules (pure functions of the step), the port of ``repro.optim.schedule``.

Each schedule takes the optimizer's step as a 0-dim integer tensor (or a
Python number) and returns a float32 tensor, formed as the reference's source
forms it in float32.  The division by a step count divides by a tensor: on
the card, a division by a Python number is a multiplication by its
reciprocal.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def _ratio(step: torch.Tensor, n: int) -> torch.Tensor:
    """``step / n`` in float32, a true division."""
    s = step.to(torch.float32)
    return s / torch.full_like(s, float(n))


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(_ratio(torch.as_tensor(step), max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)

    return lr


def linear_warmup_cosine(
    base_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def lr(step):
        step = torch.as_tensor(step)
        warm = base_lr * torch.clamp(_ratio(step, max(warmup_steps, 1)), max=1.0)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return lr
