"""Named workload scenarios: a registry of job-stream generators.

* ``paper-diurnal``         — the §V-A non-homogeneous Poisson workload; at
  ``load_scale=1.0`` it is ``generate_jobs(WorkloadSpec(), seed)``;
* ``trace-scaled``          — the diurnal trace with its rate multiplied by
  ``load_scale``;
* ``bursty-mmpp``           — a two-state Markov-modulated Poisson process on
  top of the diurnal envelope;
* ``heavy-tail-lognormal``  — diurnal arrivals with lognormal durations;
* ``heavy-tail-pareto``     — diurnal arrivals with Pareto(Lomax) durations,
  capped at ``cap_min`` minutes;
* ``weekend-flat``          — a flat low-rate day (no diurnal ramp);
* ``multi-tenant-serving``  — tenant request streams with latency SLOs, the
  model configs mapped to MIG slice classes (registered by
  :mod:`repro_torch.core.serving`, imported at the bottom).

Every generator is a pure function of ``(seed, **kwargs)``, a seeded numpy
stream drawn in the reference's order.  The port's own copy of
``repro.core.scenarios``.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np

from repro_torch.core.jobs import Job, JobKind
from repro_torch.core.workload import (
    DIURNAL_RATE_PER_MIN,
    MINUTES_PER_DAY,
    WorkloadSpec,
    arrival_rate,
    generate_jobs,
    jobs_from_arrivals,
    sample_poisson_arrivals,
)

__all__ = [
    "Scenario",
    "SCENARIOS",
    "register_scenario",
    "scenario_names",
    "resolve_scenario_kwargs",
    "generate_scenario",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A registered workload generator with its documented knob defaults."""

    name: str
    doc: str
    defaults: Mapping[str, Any]
    generate: Callable[..., List[Job]]


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(name: str, doc: str, **defaults: Any):
    """Decorator registering ``fn(seed, **kwargs) -> List[Job]`` under ``name``."""

    def deco(fn: Callable[..., List[Job]]) -> Callable[..., List[Job]]:
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        SCENARIOS[name] = Scenario(name=name, doc=doc, defaults=dict(defaults), generate=fn)
        return fn

    return deco


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


def resolve_scenario_kwargs(name: str, kwargs: Mapping[str, Any] | None = None) -> Dict[str, Any]:
    """Merge ``kwargs`` over the scenario's defaults; reject unknown knobs."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; registered: {list(scenario_names())}")
    sc = SCENARIOS[name]
    merged = dict(sc.defaults)
    for k, v in dict(kwargs or {}).items():
        if k not in merged:
            raise KeyError(
                f"scenario {name!r} has no knob {k!r}; knobs: {sorted(merged)}"
            )
        merged[k] = v
    return merged


def generate_scenario(name: str, seed: int, **kwargs: Any) -> List[Job]:
    """Generate the named scenario's job stream (sorted by arrival)."""
    resolved = resolve_scenario_kwargs(name, kwargs)
    return SCENARIOS[name].generate(seed=seed, **resolved)


# ----------------------------------------------------------------------
# generators


def _diurnal_jobs(
    seed: int,
    load_scale: float,
    horizon_min: float,
    duration_sampler=None,
) -> List[Job]:
    """Diurnal arrivals at ``load_scale`` x the Fig. 5 rate."""
    spec = WorkloadSpec(horizon_min=horizon_min)
    rng = np.random.default_rng(seed)
    lam_max = max(DIURNAL_RATE_PER_MIN) * load_scale
    arrivals = sample_poisson_arrivals(
        horizon_min, lambda t: arrival_rate(t) * load_scale, lam_max, rng
    )
    return jobs_from_arrivals(spec, arrivals, rng, duration_sampler)


@register_scenario(
    "paper-diurnal",
    "§V-A diurnal Alibaba-derived trace (Fig. 5); the paper's workload",
    load_scale=1.0,
    horizon_min=float(MINUTES_PER_DAY),
)
def _paper_diurnal(seed: int, load_scale: float, horizon_min: float) -> List[Job]:
    if load_scale == 1.0:
        return generate_jobs(WorkloadSpec(horizon_min=horizon_min), seed)
    return _diurnal_jobs(seed, load_scale, horizon_min)


@register_scenario(
    "trace-scaled",
    "diurnal trace with the arrival rate multiplied by load_scale",
    load_scale=2.0,
    horizon_min=float(MINUTES_PER_DAY),
)
def _trace_scaled(seed: int, load_scale: float, horizon_min: float) -> List[Job]:
    return _diurnal_jobs(seed, load_scale, horizon_min)


@register_scenario(
    "bursty-mmpp",
    "two-state Markov-modulated Poisson bursts over the diurnal envelope",
    burst_mult=3.0,
    quiet_mult=0.5,
    mean_burst_min=20.0,
    mean_quiet_min=120.0,
    load_scale=1.0,
    horizon_min=float(MINUTES_PER_DAY),
)
def _bursty_mmpp(
    seed: int,
    burst_mult: float,
    quiet_mult: float,
    mean_burst_min: float,
    mean_quiet_min: float,
    load_scale: float,
    horizon_min: float,
) -> List[Job]:
    spec = WorkloadSpec(horizon_min=horizon_min)
    rng = np.random.default_rng(seed)
    # the modulating chain first (alternating quiet/burst sojourns), so the
    # thinning pass sees a fixed rate trajectory
    boundaries: List[float] = [0.0]
    mults: List[float] = []
    in_burst = False
    t = 0.0
    while t < horizon_min:
        mean = mean_burst_min if in_burst else mean_quiet_min
        mults.append(burst_mult if in_burst else quiet_mult)
        t += rng.exponential(mean)
        boundaries.append(t)
        in_burst = not in_burst

    def rate(at: float) -> float:
        i = bisect.bisect_right(boundaries, at) - 1
        return arrival_rate(at) * mults[min(i, len(mults) - 1)] * load_scale

    lam_max = max(DIURNAL_RATE_PER_MIN) * max(burst_mult, quiet_mult) * load_scale
    arrivals = sample_poisson_arrivals(horizon_min, rate, lam_max, rng)
    return jobs_from_arrivals(spec, arrivals, rng)


def _lognormal_sampler(
    inf_mean: float, inf_sigma: float, train_mean: float, train_sigma: float, cap_min: float
):
    # mu chosen so E[lognormal] matches the target mean: mean = exp(mu + s^2/2)
    mu_inf = math.log(inf_mean) - inf_sigma**2 / 2.0
    mu_train = math.log(train_mean) - train_sigma**2 / 2.0

    def sample(kind: JobKind, rng: np.random.Generator) -> float:
        if kind is JobKind.INFERENCE:
            d = rng.lognormal(mu_inf, inf_sigma)
        else:
            d = rng.lognormal(mu_train, train_sigma)
        return min(max(d, 1.0 / 60.0), cap_min)

    return sample


@register_scenario(
    "heavy-tail-lognormal",
    "diurnal arrivals; lognormal durations with matched means, heavy tail",
    inf_mean=3.0,
    inf_sigma=1.2,
    train_mean=25.0,
    train_sigma=0.8,
    cap_min=480.0,
    load_scale=1.0,
    horizon_min=float(MINUTES_PER_DAY),
)
def _heavy_lognormal(
    seed: int,
    inf_mean: float,
    inf_sigma: float,
    train_mean: float,
    train_sigma: float,
    cap_min: float,
    load_scale: float,
    horizon_min: float,
) -> List[Job]:
    sampler = _lognormal_sampler(inf_mean, inf_sigma, train_mean, train_sigma, cap_min)
    return _diurnal_jobs(seed, load_scale, horizon_min, duration_sampler=sampler)


def _pareto_sampler(
    inf_xm: float, inf_alpha: float, train_xm: float, train_alpha: float, cap_min: float
):
    # Lomax + shift: d = xm * (1 + Pareto(alpha)); mean = xm * alpha/(alpha-1)
    def sample(kind: JobKind, rng: np.random.Generator) -> float:
        if kind is JobKind.INFERENCE:
            d = inf_xm * (1.0 + rng.pareto(inf_alpha))
        else:
            d = train_xm * (1.0 + rng.pareto(train_alpha))
        return min(max(d, 1.0 / 60.0), cap_min)

    return sample


@register_scenario(
    "heavy-tail-pareto",
    "diurnal arrivals; Pareto durations (capped) — the heaviest tail",
    inf_xm=1.0,
    inf_alpha=1.5,
    train_xm=10.0,
    train_alpha=1.8,
    cap_min=480.0,
    load_scale=1.0,
    horizon_min=float(MINUTES_PER_DAY),
)
def _heavy_pareto(
    seed: int,
    inf_xm: float,
    inf_alpha: float,
    train_xm: float,
    train_alpha: float,
    cap_min: float,
    load_scale: float,
    horizon_min: float,
) -> List[Job]:
    sampler = _pareto_sampler(inf_xm, inf_alpha, train_xm, train_alpha, cap_min)
    return _diurnal_jobs(seed, load_scale, horizon_min, duration_sampler=sampler)


@register_scenario(
    "weekend-flat",
    "flat low-rate day: no diurnal ramp (weekend/maintenance traffic)",
    rate_per_min=0.15,
    load_scale=1.0,
    horizon_min=float(MINUTES_PER_DAY),
)
def _weekend_flat(
    seed: int, rate_per_min: float, load_scale: float, horizon_min: float
) -> List[Job]:
    spec = WorkloadSpec(horizon_min=horizon_min, constant_rate=rate_per_min * load_scale)
    return generate_jobs(spec, seed)


# registers "multi-tenant-serving" (latency-SLO tenant streams over the
# model configs); imported last so the registry above exists when it runs
import repro_torch.core.serving  # noqa: E402,F401  (registration side effect)
