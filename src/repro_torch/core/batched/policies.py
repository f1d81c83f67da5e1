"""Batchable repartitioning policies: compiled specs, not Python callbacks.

The batched step has no room for a Python callback per rollout and step, so
the batched backend supports exactly the policies whose target configuration
is a closed-form function of time:

* ``static`` / ``nomig`` — one fixed configuration;
* ``daynight`` — the twice-daily §V-A benchmark (day config during
  [day_start, day_end) minutes-of-day, night config otherwise).

:func:`held_policy` is the RL environment's decision interval: a per-rollout
target held until the next decision (the ``static`` kind).

The port's own copy of ``repro.core.batched.policies``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.batched.tables import DeviceTables
from repro_torch.core.simulator import DayNightPolicy, RepartitionPolicy, StaticPolicy

__all__ = ["BatchedPolicy", "UnsupportedPolicyError", "compile_policy", "held_policy"]


class UnsupportedPolicyError(ValueError):
    """Raised when a policy/scheduler cannot run on the batched backend."""


@dataclasses.dataclass(frozen=True)
class BatchedPolicy:
    """A policy compiled to per-rollout config-index arrays.

    ``kind`` is ``"static"`` (target = ``primary``) or ``"daynight"``
    (target = ``primary`` during [``day_start``, ``day_end``) minutes of
    day, else ``secondary``).  All config values are *dense indices* into
    :class:`DeviceTables`, not 1-based config ids.
    """

    kind: str  # "static" | "daynight"
    initial: np.ndarray  # (B,) int32 config indices at t=0
    primary: np.ndarray  # (B,) int32 (static target / day config)
    secondary: np.ndarray  # (B,) int32 (daynight night config; unused static)
    day_start: float = 5 * 60.0
    day_end: float = 17 * 60.0

    @property
    def batch(self) -> int:
        """``B`` — rollout count this policy is compiled for."""
        return int(self.initial.shape[0])


def _bcast(values: Sequence[int], batch: int) -> np.ndarray:
    arr = np.asarray(values, dtype=np.int32)
    if arr.ndim == 0:
        arr = arr[None]
    if arr.shape[0] == 1 and batch > 1:
        arr = np.repeat(arr, batch)
    if arr.shape[0] != batch:
        raise ValueError(f"policy spec covers {arr.shape[0]} rollouts, batch is {batch}")
    return arr


def compile_policy(
    policy: RepartitionPolicy,
    tables: DeviceTables,
    batch: int,
    initial_config: Optional[int] = None,
) -> BatchedPolicy:
    """Compile one policy instance for a ``batch``-wide rollout.

    ``initial_config`` overrides the policy's own ``initial_config``.  Raises
    :class:`UnsupportedPolicyError` for policies that need simulator state.
    """
    init_id = policy.initial_config if initial_config is None else initial_config
    init = _bcast([tables.index_of(int(init_id))], batch)
    if isinstance(policy, DayNightPolicy):
        return BatchedPolicy(
            kind="daynight",
            initial=init,
            primary=_bcast([tables.index_of(policy.day_config)], batch),
            secondary=_bcast([tables.index_of(policy.night_config)], batch),
            day_start=float(policy.day_start),
            day_end=float(policy.day_end),
        )
    # NoMIGPolicy subclasses StaticPolicy, so this covers static + nomig.
    if isinstance(policy, StaticPolicy):
        return BatchedPolicy(
            kind="static", initial=init, primary=init, secondary=init
        )
    raise UnsupportedPolicyError(
        f"policy {type(policy).__name__} needs per-event simulator state; "
        "the batched backend supports static/nomig/daynight (and the RL env's "
        "held-target stepping) — run this cell on the oracle backend"
    )


def held_policy(targets: np.ndarray, current: np.ndarray) -> BatchedPolicy:
    """A per-rollout held-target policy (the RL env decision interval).

    ``targets`` are dense config indices to switch to (and hold); ``current``
    seeds ``initial`` so no switch is charged when a rollout keeps its
    configuration.
    """
    targets = np.asarray(targets, dtype=np.int32)
    current = np.asarray(current, dtype=np.int32)
    if targets.shape != current.shape:
        raise ValueError("targets/current shape mismatch")
    return BatchedPolicy(
        kind="static", initial=current, primary=targets, secondary=targets
    )
