"""Constants and repartitioning policies of the MIG simulator.

A slim copy of ``repro.core.simulator``: only what the batched simulator
(:mod:`repro_torch.core.batched`) reads — the §IV-D-3 repartition penalty,
the repartition modes, the semantics version tag, and the three policies
whose target configuration is a closed-form function of time (static, no-MIG
and the twice-daily day/night benchmark).  ``MIGSimulator`` and the
event-driven engine, the reference's bit-exact oracle, are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Protocol

__all__ = [
    "RepartitionPolicy",
    "StaticPolicy",
    "NoMIGPolicy",
    "DayNightPolicy",
    "REPARTITION_PENALTY_MIN",
    "REPARTITION_MODES",
    "SIM_VERSION",
]

# Version tag of the simulation semantics (the reference's, which the port's
# batched step reproduces).
SIM_VERSION = "mig-sim-4"

# §IV-D-3: destroying/recreating MIG slices takes ~4 seconds.
REPARTITION_PENALTY_MIN = 4.0 / 60.0

#: valid repartition modes: ``"partial"`` (slot-placed transition, survivors
#: keep running) and ``"drain"`` (every slice destroyed on a switch).
REPARTITION_MODES = ("partial", "drain")

_EPS = 1e-9


class RepartitionPolicy(Protocol):
    """Decides the MIG configuration at decision points."""

    initial_config: int

    def next_timer(self, t: float) -> Optional[float]:
        """Next time-triggered decision point strictly after ``t`` (or None)."""
        ...


class StaticPolicy:
    """Fixed configuration; never repartitions (Static MIG benchmark)."""

    def __init__(self, config_id: int) -> None:
        self.initial_config = config_id

    def decide(self, t: float, sim) -> Optional[int]:
        return None

    def next_timer(self, t: float) -> Optional[float]:
        return None


class NoMIGPolicy(StaticPolicy):
    """Full GPU, MIG disabled (No MIG benchmark).

    Config 1 (one 7g.40gb slice); run with ``mig_enabled=False`` so that
    linear jobs get the §V-A 6 % full-GPU speedup.
    """

    def __init__(self) -> None:
        super().__init__(config_id=1)


class DayNightPolicy:
    """Twice-daily repartitioning benchmark (§V-A).

    Config ``day_config`` during 5:00-17:00, ``night_config`` otherwise.
    """

    def __init__(self, day_config: int = 6, night_config: int = 2) -> None:
        self.day_config = day_config
        self.night_config = night_config
        self.day_start = 5 * 60.0
        self.day_end = 17 * 60.0
        self.initial_config = self._target(0.0)

    def _target(self, t: float) -> int:
        tod = t % (24 * 60.0)
        return (
            self.day_config
            if self.day_start <= tod < self.day_end
            else self.night_config
        )

    def decide(self, t: float, sim) -> Optional[int]:
        tgt = self._target(t)
        return tgt if tgt != sim.partition.config_id else None

    def next_timer(self, t: float) -> Optional[float]:
        day = 24 * 60.0
        base = math.floor(t / day) * day
        for bound in (base + self.day_start, base + self.day_end,
                      base + day + self.day_start):
            if bound > t + _EPS:
                return bound
        return None  # pragma: no cover
