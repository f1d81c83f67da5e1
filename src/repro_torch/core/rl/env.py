"""The §IV-D state and reward contract of the repartitioning DQN (host constants).

The port's own copy of what the batched env and the on-device trainer read
from ``repro.core.rl.env``: the feature layout (``2 + 2m`` binned features,
m = 8), the bin tables and sentinels, and the ET-scalarized reward.  The
incremental ``RepartitionEnv``, ``state_features`` and the fleet features sit
on the event-driven engine, which the port does not have; they are not
copied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from repro_torch.core.slices import ALL_SLICE_SIZES

__all__ = ["M_JOBS", "FEATURE_DIM", "RewardWeights", "inv_mean_durations"]

# The paper uses m=3 (§IV-D-1); the same load-driven analysis on the §V-A
# calibration selects m=8, in the paper's 2+2m layout.
M_JOBS = 8
FEATURE_DIM = 2 + 2 * M_JOBS

# Bin edges (minutes) for deadline slack and average duration.
_BIN_EDGES = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0])
_NUM_BINS = len(_BIN_EDGES) + 1  # 10 bins
_TIME_BINS = 48  # half-hour bins over the day


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    """ET-scalarized reward: r = -(a*dE + dTard/m) / (a+1) / scale.

    ``a`` ~ t/(2s) calibrated on the diurnal workload (mean energy s ~ 4.1 kWh
    per day, mean avg-tardiness t ~ 1.2 min).  The tardiness integral is
    normalized by the expected jobs per episode, so the summed episode reward
    approximates -ET of the episode (§IV-A uses *average* tardiness).
    """

    a: float = 5e-5
    tardiness_norm: float = 600.0  # ~ expected jobs per diurnal day
    scale: float = 0.01  # keeps |r| O(1) for stable TD learning
    # §IV-D-3: a repartition costs the time it takes (4 s); the explicit
    # term de-noises credit assignment for the switch decision itself
    switch_penalty_min: float = 4.0 / 60.0

    def interval_reward(self, d_energy_wh: float, d_tardiness: float) -> float:
        y = d_tardiness / self.tardiness_norm
        return -((self.a * d_energy_wh + y) / (self.a + 1.0)) / self.scale

    def switch_penalty(self, jobs_in_system: int) -> float:
        """Reward cost of a repartition: ~4 s of lost service for the whole
        system, in the same normalized-tardiness units."""
        y = self.switch_penalty_min * max(jobs_in_system, 1) / self.tardiness_norm
        return (y / (self.a + 1.0)) / self.scale


def inv_mean_durations(job_lists: Sequence[Sequence[Any]], shape, dtype) -> np.ndarray:
    """Per-job coefficient of the mean-duration feature, ``(B, J)`` in ``dtype``.

    The duration averaged over the canonical slice sizes at mig=True
    (``Job.mean_duration_all_sizes``) is linear in the remaining work, so one
    coefficient per job suffices: ``mean(1 / rate_on(k, True))``, summed in
    Python floats, then stored in ``dtype`` (the env keeps float64, the
    trainer float32, as the reference does).
    """
    inv = np.zeros(shape, dtype=dtype)
    for b, jobs in enumerate(job_lists):
        for j, job in enumerate(jobs):
            inv[b, j] = sum(
                1.0 / job.rate_on(float(k), True) for k in ALL_SLICE_SIZES
            ) / len(ALL_SLICE_SIZES)
    return inv
