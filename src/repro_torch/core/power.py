"""Power model of the paper's Fig. 3 (A100 at the default 250 W cap).

Power is a *concave, saturating* function of busy compute slots: a lookup on
busy slots 0..7 with linear interpolation.  Energy is in watt-hours; the
simulator's time unit is minutes.

The port's own copy of ``repro.core.power`` with the one model the batched
simulator and the event-driven simulator read; the A30 and TPU-pod curves
belong to the fleet layer.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["PowerModel", "A100_250W"]


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Piecewise-linear power (watts) vs number of busy compute slots."""

    name: str
    watts_by_busy_slots: Tuple[float, ...]  # index 0 == idle
    total_slots: int

    def __post_init__(self) -> None:
        if len(self.watts_by_busy_slots) != self.total_slots + 1:
            raise ValueError("need total_slots+1 power entries (incl. idle)")
        w = self.watts_by_busy_slots
        if any(b > a + 1e-9 for a, b in zip(w[1:], w, strict=False)):
            raise ValueError("power must be nondecreasing in busy slots")

    def power_watts(self, busy_slots: float) -> float:
        """Power draw with ``busy_slots`` compute slots busy (interpolated)."""
        u = min(max(busy_slots, 0.0), float(self.total_slots))
        lo = int(u)
        hi = min(lo + 1, self.total_slots)
        frac = u - lo
        w = self.watts_by_busy_slots
        return w[lo] * (1.0 - frac) + w[hi] * frac

    def energy_wh(self, busy_slots: float, minutes: float) -> float:
        """Energy in watt-hours for an interval at constant utilization."""
        return self.power_watts(busy_slots) * minutes / 60.0

    @property
    def idle_watts(self) -> float:
        return self.watts_by_busy_slots[0]

    @property
    def peak_watts(self) -> float:
        return self.watts_by_busy_slots[-1]


# Fig. 3 (A100-40GB, 250 W cap): steep marginal power up to 4 busy slots, then
# nearly flat.  Exact tabular values are not published; these reproduce the
# described shape.
A100_250W = PowerModel(
    name="a100-40gb-250w",
    watts_by_busy_slots=(65.0, 135.0, 185.0, 222.0, 243.0, 248.0, 250.0, 250.0),
    total_slots=7,
)
