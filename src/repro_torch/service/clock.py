"""The service's replay clock: wall seconds -> simulated minutes.

A live service runs its simulated day against real time at a configurable
``speedup`` (simulated minutes per wall minute; ``60`` replays a 24 h day
in 24 wall minutes).  The clock is *advisory*: it decides how far the idle
tick advances the engine and how submission arrivals are stamped, but the
WAL records the resulting sim-times — replay after a crash never consults
a clock, so recovery is bit-identical regardless of wall-clock pacing
(the chunk-invariance of ``SimulationEngine.run_until`` is what makes
tick boundaries invisible to the final state; DESIGN.md §10).

``speedup=0`` (``ReplayClock.free()``) disables pacing entirely: time is
driven only by the ops themselves (each op's explicit ``t`` / arrival),
which is the mode the test suite and the replay CLI use.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["ReplayClock"]


class ReplayClock:
    """Affine wall->sim mapping with re-anchoring (see module docstring)."""

    def __init__(
        self,
        speedup: float = 60.0,
        *,
        start_sim_min: float = 0.0,
        time_source: Callable[[], float] = time.monotonic,
    ) -> None:
        if speedup < 0.0:
            raise ValueError(f"speedup must be >= 0, got {speedup}")
        self.speedup = speedup
        self._src = time_source
        self._t0_wall = time_source()
        self._t0_sim = start_sim_min

    @classmethod
    def free(cls) -> "ReplayClock":
        """A non-advancing clock: op times alone drive the simulation."""
        return cls(speedup=0.0)

    @property
    def paced(self) -> bool:
        """Whether wall time advances the simulation at all."""
        return self.speedup > 0.0

    def now(self) -> float:
        """Current simulated time in minutes."""
        if self.speedup == 0.0:
            return self._t0_sim
        return self._t0_sim + (self._src() - self._t0_wall) * self.speedup / 60.0

    def resync(self, sim_min: float) -> None:
        """Re-anchor so ``now()`` reads ``sim_min`` at this wall instant.

        Called after crash recovery: the restored engine resumes at the
        time it had reached, not at the wall time the outage consumed.
        """
        self._t0_wall = self._src()
        self._t0_sim = sim_min

    def wall_seconds_until(self, sim_min: float) -> float:
        """Wall seconds until the clock reads ``sim_min`` (0 if past)."""
        if self.speedup == 0.0:
            return 0.0
        return max((sim_min - self.now()) * 60.0 / self.speedup, 0.0)

    def sleep_until(self, sim_min: float) -> None:
        """Block until the clock reads ``sim_min`` (paced replay feeding)."""
        delay = self.wall_seconds_until(sim_min)
        if delay > 0.0:
            time.sleep(delay)
