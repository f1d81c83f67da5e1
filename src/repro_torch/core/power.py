"""Power model of the paper's Fig. 3 (A100 at the default 250 W cap).

Power is a *concave, saturating* function of busy compute slots: a lookup on
busy slots 0..7 with linear interpolation.  Energy is in watt-hours; the
simulator's time unit is minutes.

The port's own copy of ``repro.core.power``: the A100 curve the batched and
the event-driven simulators read, and the fleet layer's other two device
curves (:mod:`repro_torch.fleet.devices`), copied as the tables the
reference's ``make_saturating_power`` computes: an A30-class device and the
reference's *simulated* TPU v5e pod (a modelled curve, not a measurement).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["PowerModel", "A100_250W", "A30_165W", "TPU_V5E_POD"]


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


# A30-class fleet profile (24GB, 165 W TDP, 4 MIG compute slots): the Fig. 3
# shape at A30 scale, idle ~30 W (the reference's make_saturating_power(idle
# 30, peak 165, 4 slots), as its table).
A30_165W = PowerModel(
    name="a30-24gb-165w",
    watts_by_busy_slots=(30.0, 115.2526799029674, 147.81381985982483, 160.2501190646919, 165.0),
    total_slots=4,
)


# The reference's TPU v5e pod adaptation: 256 chips as 7 "slots", idle ~100
# W/chip, busy ~300 W/chip, the Fig. 3 shape (make_saturating_power(idle
# 25,600, peak 76,800, 7 slots), as its table).  A simulated device curve.
TPU_V5E_POD = PowerModel(
    name="tpu-v5e-pod-256",
    watts_by_busy_slots=(25600.0, 47731.113981125105, 60499.655996044174, 67866.463890387,
                         72116.74230813757, 74568.93963532304, 75983.73441825825, 76800.0),
    total_slots=7,
)
