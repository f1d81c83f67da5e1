"""Outcome of one simulation run (paper §IV-A's energy and tardiness).

The port's own copy of ``repro.core.metrics.SimResult``, the record
:meth:`repro_torch.core.batched.BatchedResult.to_sim_results` returns.  The
ET metric and the serving tenants' SLO statistics are not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["SimResult"]


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Outcome of one simulation run."""

    energy_wh: float
    avg_tardiness: float
    num_jobs: int = 0
    total_tardiness: float = 0.0
    preemptions: int = 0
    repartitions: int = 0
    max_tardiness: float = 0.0
    deadline_misses: int = 0
    busy_slot_minutes: float = 0.0  # integral of busy slots over time
    extra: Mapping[str, float] = dataclasses.field(default_factory=dict)
