"""AdamW over lists of tensors, the port of ``repro.optim.adamw``.

The reference's arithmetic, op for op, in float32: the bias corrections
``bc1 = 1 - b1**step`` and ``bc2 = 1 - b2**step`` divide the moments
(``mhat / (sqrt(vhat) + eps)``), decoupled weight decay applies only to
tensors with ``ndim >= 2``, and global-norm clipping scales by
``min(1, clip / (norm + 1e-9))``.  ``torch.optim.Adam``/``AdamW`` fold the
bias correction into the step size, which moves ``eps``; they are not used.

``state_dtype="bfloat16"`` keeps ``m`` and ``v`` in bf16 (the update itself
runs in float32 and rounds them on store).  The update is pure: it returns
new tensors and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence

import torch

__all__ = ["AdamWConfig", "OptState", "AdamW"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Any = 3e-4  # float or Callable[step] -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None  # None = float32


class OptState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: torch.Tensor  # 0-dim int32


class AdamW:
    def __init__(self, cfg: AdamWConfig) -> None:
        self.cfg = cfg

    def _state_dtype(self) -> torch.dtype:
        if self.cfg.state_dtype is not None:
            return getattr(torch, self.cfg.state_dtype)
        return torch.float32

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        dt = self._state_dtype()
        device = params[0].device if len(params) else None
        return OptState(
            # zeros_like keeps a DTensor leaf's placements (the state mirrors the params)
            m=[torch.zeros_like(p, dtype=dt) for p in params],
            v=[torch.zeros_like(p, dtype=dt) for p in params],
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    def _lr(self, step: torch.Tensor):
        if callable(self.cfg.lr):
            return self.cfg.lr(step)
        return torch.tensor(self.cfg.lr, dtype=torch.float32, device=step.device)

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]):
        """``(new_params, new_state)`` after one step on ``grads``."""
        cfg = self.cfg
        if not len(grads) == len(params) == len(state.m) == len(state.v):
            raise ValueError("grads, params and optimizer state differ in length")
        step = state.step + 1

        grads = [g.to(torch.float32) for g in grads]
        if cfg.grad_clip_norm is not None:
            # Python's sum from 0, leaf by leaf, as the reference adds them
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            # a true division: ``float / tensor`` is a reciprocal times the float
            clip = torch.full_like(gnorm, cfg.grad_clip_norm)
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
            grads = [g * scale for g in grads]

        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(cfg.b1, stepf)
        bc2 = 1.0 - torch.pow(cfg.b2, stepf)
        lr = self._lr(step)

        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(params, grads, state.m, state.v, strict=True):
            mf = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g
            vf = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g * g
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if cfg.weight_decay > 0.0 and p.ndim >= 2:  # no decay on norms/bias
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
            new_m.append(mf.to(m.dtype))
            new_v.append(vf.to(v.dtype))
        return new_p, OptState(m=new_m, v=new_v, step=step)
