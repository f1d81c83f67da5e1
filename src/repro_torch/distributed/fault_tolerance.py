"""Fault tolerance & straggler mitigation for the cluster layer.

At thousand-node scale the scheduler IS the recovery mechanism (DESIGN.md §5):

* **heartbeats**: every slice (sub-mesh) posts a heartbeat; a missed-deadline
  monitor marks the slice failed,
* **failure handling**: jobs on a failed slice are preempted back to the
  queue with their last-checkpoint progress (work since the last checkpoint
  is lost — the simulator charges it); the repartitioning policy then picks a
  configuration for the *surviving* slots, i.e. the paper's mechanism doubles
  as elastic down-scaling,
* **stragglers**: a slice whose observed service rate falls below
  ``straggler_factor`` of nominal is drained and its jobs re-dispatched
  (speculative re-execution is pointless under MIG-style isolation — the
  paper's preemption machinery already moves work for free),
* **elastic resume**: the reference restores a checkpoint onto a different
  mesh; the port runs on one card and has no mesh (ROADMAP.md A.7).

The port's own copy of ``repro.distributed.fault_tolerance``: numpy host
code, seeded as the reference's, so the same seed samples the same failures.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["HeartbeatMonitor", "FailureModel", "StragglerDetector"]


@dataclasses.dataclass
class FailureModel:
    """Poisson slice failures + deterministic repair times (simulation)."""

    mtbf_minutes: float = 7 * 24 * 60.0  # per-slice mean time between failures
    repair_minutes: float = 30.0
    checkpoint_interval_min: float = 10.0  # job progress lost since last ckpt
    seed: int = 0

    def sample_failures(
        self, num_slices: int, horizon_min: float
    ) -> List[Tuple[float, int, float]]:
        """Returns [(t_fail, slice_idx, t_repaired)] sorted by time."""
        rng = np.random.default_rng(self.seed)
        events = []
        for s in range(num_slices):
            t = 0.0
            while True:
                t += rng.exponential(self.mtbf_minutes)
                if t >= horizon_min:
                    break
                events.append((t, s, t + self.repair_minutes))
        events.sort()
        return events

    def lost_work(self, progress_since_ckpt: float) -> float:
        """Work lost on failure = progress since the last checkpoint."""
        return min(progress_since_ckpt, self.checkpoint_interval_min)


class HeartbeatMonitor:
    """Deadline-based liveness: slice must beat every ``interval`` minutes."""

    def __init__(self, interval_min: float = 1.0, misses_to_fail: int = 3) -> None:
        self.interval = interval_min
        self.misses_to_fail = misses_to_fail
        self.last_beat: Dict[int, float] = {}
        self.failed: set = set()

    def beat(self, slice_idx: int, t: float) -> None:
        self.last_beat[slice_idx] = t
        self.failed.discard(slice_idx)

    def check(self, t: float) -> List[int]:
        """Slices newly declared failed at time t."""
        newly = []
        for s, last in self.last_beat.items():
            if s in self.failed:
                continue
            if t - last > self.interval * self.misses_to_fail:
                self.failed.add(s)
                newly.append(s)
        return newly


class StragglerDetector:
    """EWMA service-rate tracking; flags slices below factor x nominal."""

    def __init__(self, straggler_factor: float = 0.7, alpha: float = 0.3) -> None:
        self.factor = straggler_factor
        self.alpha = alpha
        self.rate_ewma: Dict[int, float] = {}

    def observe(self, slice_idx: int, observed_rate: float, nominal_rate: float) -> bool:
        """Update EWMA; returns True if the slice is now a straggler."""
        prev = self.rate_ewma.get(slice_idx, nominal_rate)
        ewma = self.alpha * observed_rate + (1 - self.alpha) * prev
        self.rate_ewma[slice_idx] = ewma
        return ewma < self.factor * nominal_rate

    def reset(self, slice_idx: int) -> None:
        self.rate_ewma.pop(slice_idx, None)
