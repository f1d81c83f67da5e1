"""Optimizer substrate of the port: AdamW, schedules and clipping, as the reference has them."""

from repro_torch.optim.adamw import AdamW, AdamWConfig, OptState
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamW",
    "AdamWConfig",
    "OptState",
    "cosine_schedule",
    "linear_warmup_cosine",
]
