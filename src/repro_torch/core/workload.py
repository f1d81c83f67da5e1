"""Workload generation (paper §V-A).

Jobs arrive by a non-homogeneous Poisson process whose rate follows the
diurnal pattern of Fig. 5.  Per-job attributes: kind (inference w.p.
``inference_split``), duration on a 1g slice (inference ~ Exp(mean 3 min),
training ~ U(10, 40) min), elasticity (linear / capped / sublinear equally
likely) and deadline ``arrival + slack * dur_on_7g`` with slack ~
U(slack_lo, slack_hi).

The port's own copy of ``repro.core.workload``.  A stream is a seeded numpy
stream, and every draw is made in the reference's order, so the same seed
gives bit-identical jobs in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.jobs import (
    LINEAR,
    SUBLINEAR_CURVES,
    Elasticity,
    Job,
    JobKind,
    capped,
)

__all__ = [
    "WorkloadSpec",
    "DIURNAL_RATE_PER_MIN",
    "MINUTES_PER_DAY",
    "arrival_rate",
    "generate_jobs",
    "sample_poisson_arrivals",
    "jobs_from_arrivals",
    "DurationSampler",
]

MINUTES_PER_DAY = 24 * 60

# Fig. 5 — arrival rate (jobs/min) by hour of day, linearly interpolated.
DIURNAL_RATE_PER_MIN: Sequence[float] = (
    0.10, 0.08, 0.08, 0.10, 0.22,  # 0..4h (ramp starts ~3-4h)
    0.38, 0.44, 0.48, 0.50, 0.52,  # 5..9h
    0.54, 0.55, 0.54, 0.52, 0.50,  # 10..14h
    0.48, 0.45, 0.40, 0.28, 0.18,  # 15..19h (falls 17-19h)
    0.14, 0.12, 0.10, 0.10,        # 20..23h
)


def arrival_rate(t_min: float, pattern: Sequence[float] = DIURNAL_RATE_PER_MIN) -> float:
    """Interpolated arrival rate (jobs/min) at absolute time ``t_min``."""
    hod = (t_min / 60.0) % 24.0
    lo = int(hod) % 24
    hi = (lo + 1) % 24
    frac = hod - int(hod)
    return pattern[lo] * (1.0 - frac) + pattern[hi] * frac


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """All knobs of the §V-A workload model."""

    horizon_min: float = float(MINUTES_PER_DAY)
    constant_rate: Optional[float] = None  # jobs/min; None => diurnal Fig. 5
    inference_split: float = 0.8
    # §V-A "exponentially distributed with a lambda value of 3", read as a
    # mean of 3 minutes (see the reference's module for why)
    inference_mean_min: float = 3.0
    training_lo_min: float = 10.0
    training_hi_min: float = 40.0
    slack_lo: float = 1.2
    slack_hi: float = 4.0
    linear_no_mig_speedup: float = 1.06  # §V-A: full GPU 6% faster for linear jobs

    def rate(self, t_min: float) -> float:
        if self.constant_rate is not None:
            return self.constant_rate
        return arrival_rate(t_min)

    @property
    def peak_rate(self) -> float:
        if self.constant_rate is not None:
            return self.constant_rate
        return max(DIURNAL_RATE_PER_MIN)


def sample_poisson_arrivals(
    horizon_min: float,
    rate_fn: Callable[[float], float],
    lam_max: float,
    rng: np.random.Generator,
) -> List[float]:
    """Thinning sampler for a (non-)homogeneous Poisson process.

    ``rate_fn(t)`` must never exceed ``lam_max`` on [0, horizon_min); the
    returned arrival times are strictly increasing.
    """
    t = 0.0
    out: List[float] = []
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= horizon_min:
            break
        if rng.uniform() * lam_max <= rate_fn(t):
            out.append(t)
    return out


def _sample_arrivals(spec: WorkloadSpec, rng: np.random.Generator) -> List[float]:
    """A spec's arrivals (the cluster workload draws from it too)."""
    return sample_poisson_arrivals(spec.horizon_min, spec.rate, spec.peak_rate, rng)


def _sample_elasticity(rng: np.random.Generator) -> Elasticity:
    u = rng.integers(0, 3)
    if u == 0:
        return LINEAR
    if u == 1:
        return capped(int(rng.choice([2, 3, 4])))
    label = list(SUBLINEAR_CURVES)[int(rng.integers(0, len(SUBLINEAR_CURVES)))]
    return SUBLINEAR_CURVES[label]


#: Optional per-job duration override: ``(kind, rng) -> work`` in 1g-minutes.
#: Must perform exactly one bounded draw so job attributes stay deterministic.
DurationSampler = Callable[[JobKind, np.random.Generator], float]


def _sample_work(
    spec: WorkloadSpec,
    kind: JobKind,
    rng: np.random.Generator,
    duration_sampler: Optional[DurationSampler] = None,
) -> float:
    if duration_sampler is not None:
        return duration_sampler(kind, rng)
    if kind is JobKind.INFERENCE:
        work = rng.exponential(spec.inference_mean_min)
        return max(work, 1.0 / 60.0)  # floor at one second
    return rng.uniform(spec.training_lo_min, spec.training_hi_min)


def jobs_from_arrivals(
    spec: WorkloadSpec,
    arrivals: Sequence[float],
    rng: np.random.Generator,
    duration_sampler: Optional[DurationSampler] = None,
) -> List[Job]:
    """Draw per-job attributes (§V-A) for pre-sampled arrival times.

    The draws per job are, in order: split, duration, elasticity, slack.
    """
    jobs: List[Job] = []
    for i, t in enumerate(arrivals):
        is_inf = rng.uniform() < spec.inference_split
        kind = JobKind.INFERENCE if is_inf else JobKind.TRAINING
        work = _sample_work(spec, kind, rng, duration_sampler)
        elast = _sample_elasticity(rng)
        slack = rng.uniform(spec.slack_lo, spec.slack_hi)
        dur_fastest = elast.duration(work, 7)
        deadline = t + slack * dur_fastest
        jobs.append(
            Job(
                job_id=i,
                kind=kind,
                arrival=t,
                work=work,
                deadline=deadline,
                elasticity=elast,
                speedup_no_mig=spec.linear_no_mig_speedup
                if elast is LINEAR
                else 1.0,
            )
        )
    return jobs


def generate_jobs(
    spec: WorkloadSpec,
    seed: int,
    max_jobs: Optional[int] = None,
) -> List[Job]:
    """Generate one simulation's job queue (sorted by arrival)."""
    rng = np.random.default_rng(seed)
    arrivals = _sample_arrivals(spec, rng)
    if max_jobs is not None:
        arrivals = arrivals[:max_jobs]
    return jobs_from_arrivals(spec, arrivals, rng)
