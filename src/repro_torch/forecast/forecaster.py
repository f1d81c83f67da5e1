"""Arrival-rate forecasting: fitted diurnal Fourier day-model + EWMA bias.

The paper's workload (§V-A, Fig. 5) is a non-homogeneous Poisson process
whose rate repeats daily.  A predictive repartitioning controller needs
λ̂(t+h) for lookahead horizons h of one to a few hours; we factor that into

* a **day model** — a truncated Fourier series over the 24 h period fitted
  by least squares to binned arrival counts from training days (any
  registered :mod:`repro_torch.core.scenarios` entry), capturing the recurring
  diurnal shape, and
* an **EWMA bias tracker** — an online multiplicative correction
  ``observed / predicted`` over trailing windows of the *current* day, so a
  hotter- or quieter-than-usual day shifts every forecast up or down without
  refitting.

Both parts are deterministic: the fit is a least-squares solve on
deterministic scenario streams, and the tracker's state is a pure function
of the observed arrival count sequence.

The port's own copy of ``repro.forecast.forecaster``, whole.  The fit stays
``np.linalg.lstsq`` (LAPACK's least-squares solver), as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FourierDayModel",
    "fit_fourier_day_model",
    "fit_scenario_forecaster",
    "EWMABiasTracker",
    "ArrivalForecaster",
]

MINUTES_PER_DAY = 24 * 60.0


@dataclasses.dataclass(frozen=True)
class FourierDayModel:
    """Diurnal rate model: truncated Fourier series over a 24 h period.

    ``rate(t) = max(c0 + Σ_k a_k cos(2πkt/T) + b_k sin(2πkt/T), floor)``
    with ``t`` in absolute minutes (the day phase is ``t mod T``).  Floors at
    ``min_rate`` because a thinning sampler / fluid model needs λ ≥ 0.
    """

    mean: float  # c0, jobs/min
    cos_coeffs: Tuple[float, ...]  # a_1..a_K
    sin_coeffs: Tuple[float, ...]  # b_1..b_K
    period_min: float = MINUTES_PER_DAY
    min_rate: float = 0.0

    @property
    def harmonics(self) -> int:
        return len(self.cos_coeffs)

    def rate(self, t_min: float) -> float:
        """Forecast arrival rate (jobs/min) at absolute time ``t_min``."""
        w = 2.0 * math.pi * (t_min % self.period_min) / self.period_min
        r = self.mean
        for k in range(self.harmonics):
            r += self.cos_coeffs[k] * math.cos((k + 1) * w)
            r += self.sin_coeffs[k] * math.sin((k + 1) * w)
        return max(r, self.min_rate)

    def mean_rate(self, t0: float, t1: float, steps: int = 8) -> float:
        """Average forecast rate over [t0, t1] (midpoint rule)."""
        if t1 <= t0:
            return self.rate(t0)
        dt = (t1 - t0) / steps
        return sum(self.rate(t0 + (i + 0.5) * dt) for i in range(steps)) / steps


def fit_fourier_day_model(
    arrival_times: Sequence[float],
    total_minutes: float,
    harmonics: int = 3,
    bin_min: float = 15.0,
    min_rate: float = 0.0,
    num_streams: int = 1,
) -> FourierDayModel:
    """Least-squares Fourier fit to arrivals folded onto one day.

    ``arrival_times`` holds the pooled arrivals of ``num_streams``
    independent observation spans, each covering ``[0, total_minutes)``
    (a single span may run several days); counts are folded onto
    day-of-period bins, converted to an empirical rate (jobs/min) per bin
    using the per-bin observation coverage, and fit with ``harmonics``
    Fourier pairs.  Keeping the per-stream span explicit matters for
    sub-day horizons: eight 4-hour streams cover the same four hours eight
    times — not 32 hours wrapped around the clock.  Deterministic: a dense
    least-squares solve, no RNG.
    """
    if total_minutes <= 0.0:
        raise ValueError("total_minutes must be positive")
    if num_streams < 1:
        raise ValueError("num_streams must be >= 1")
    n_bins = max(int(round(MINUTES_PER_DAY / bin_min)), 1)
    width = MINUTES_PER_DAY / n_bins
    counts = np.zeros(n_bins)
    for t in arrival_times:
        counts[int((t % MINUTES_PER_DAY) / width) % n_bins] += 1.0
    # minutes of observation covering each day-bin: one span's coverage
    # (handles partial days), replicated across the identical-phase streams
    coverage = np.zeros(n_bins)
    full_days, rem = divmod(total_minutes, MINUTES_PER_DAY)
    coverage += full_days * width
    for b in range(n_bins):
        lo = b * width
        coverage[b] += min(max(rem - lo, 0.0), width)
    coverage *= num_streams
    observed = coverage > 1e-9
    rates = counts[observed] / coverage[observed]
    centers = (np.arange(n_bins)[observed] + 0.5) * width
    w = 2.0 * np.pi * centers / MINUTES_PER_DAY
    cols = [np.ones_like(w)]
    for k in range(1, harmonics + 1):
        cols.append(np.cos(k * w))
        cols.append(np.sin(k * w))
    design = np.stack(cols, axis=1)
    coeffs, *_ = np.linalg.lstsq(design, rates, rcond=None)
    return FourierDayModel(
        mean=float(coeffs[0]),
        cos_coeffs=tuple(float(c) for c in coeffs[1::2]),
        sin_coeffs=tuple(float(c) for c in coeffs[2::2]),
        min_rate=min_rate,
    )


@functools.lru_cache(maxsize=32)
def fit_scenario_forecaster(
    scenario: str = "paper-diurnal",
    train_seeds: int = 8,
    harmonics: int = 3,
    bin_min: float = 15.0,
    scenario_kwargs: Tuple[Tuple[str, object], ...] = (),
) -> FourierDayModel:
    """Fit a day model on ``train_seeds`` days of a registered scenario.

    Each seed generates one independent scenario stream; arrivals from all
    of them are folded into the day-bin fit, so the model sees the *mean*
    diurnal shape rather than one day's Poisson noise.  Cached per argument
    tuple — sweep workers fitting the same model pay the generation cost
    once per process.  ``scenario_kwargs`` is a sorted tuple of pairs (not a
    dict) so the cache key is hashable; :func:`ForecastPolicy` callers
    normally go through :func:`repro_torch.forecast.policy.ForecastPolicy`'s
    factory which handles the conversion.
    """
    from repro_torch.core.scenarios import generate_scenario, resolve_scenario_kwargs

    kwargs = dict(scenario_kwargs)
    resolved = resolve_scenario_kwargs(scenario, kwargs)
    horizon = float(resolved.get("horizon_min", MINUTES_PER_DAY))
    arrivals: list = []
    for seed in range(train_seeds):
        arrivals.extend(j.arrival for j in generate_scenario(scenario, seed=seed, **kwargs))
    return fit_fourier_day_model(
        arrivals,
        total_minutes=horizon,
        harmonics=harmonics,
        bin_min=bin_min,
        num_streams=train_seeds,
    )


@dataclasses.dataclass
class EWMABiasTracker:
    """Online multiplicative bias over a day model: EWMA of observed/expected.

    At each update the tracker is handed the cumulative arrival count; it
    closes trailing windows of ``window_min`` minutes, computes the ratio of
    observed arrivals to the day model's expectation for that window, and
    folds it into an exponentially weighted level.  ``bias`` multiplies
    every forecast, clipped to ``[clip_lo, clip_hi]`` so a silent night
    cannot zero out (or a burst blow up) the whole lookahead.

    Deterministic given the (t, cumulative-count) observation sequence.
    """

    alpha: float = 0.15
    window_min: float = 30.0
    clip_lo: float = 0.6
    clip_hi: float = 2.5
    level: float = 1.0
    _window_start: float = 0.0
    _window_base_count: int = 0

    def update(self, model: FourierDayModel, t: float, cumulative_count: int) -> None:
        """Fold any completed observation windows up to time ``t``."""
        if t < self._window_start:  # new episode reusing the policy object
            self.reset()
        while t - self._window_start >= self.window_min:
            w0 = self._window_start
            w1 = w0 + self.window_min
            expected = model.mean_rate(w0, w1) * self.window_min
            # attribute the cumulative count seen *now* to the closed window;
            # windows close in order so each arrival is counted exactly once
            observed = cumulative_count - self._window_base_count
            if expected > 1e-9:
                ratio = observed / expected
                self.level += self.alpha * (ratio - self.level)
            self._window_start = w1
            self._window_base_count = cumulative_count

    @property
    def bias(self) -> float:
        return min(max(self.level, self.clip_lo), self.clip_hi)

    def reset(self) -> None:
        self.level = 1.0
        self._window_start = 0.0
        self._window_base_count = 0


class ArrivalForecaster:
    """Day model + online bias: the rate source a :class:`ForecastPolicy` reads.

    ``observe(t, cumulative_count)`` is called by the policy at decision
    events with the total number of arrivals the simulator has seen so far;
    ``rate(t)`` then returns the bias-corrected forecast.  A fresh tracker
    is installed by :meth:`reset` (per simulated day/episode).
    """

    def __init__(
        self,
        model: FourierDayModel,
        tracker: Optional[EWMABiasTracker] = None,
    ) -> None:
        self.model = model
        self.tracker = tracker if tracker is not None else EWMABiasTracker()

    def observe(self, t: float, cumulative_count: int) -> None:
        self.tracker.update(self.model, t, cumulative_count)

    def rate(self, t: float) -> float:
        return self.model.rate(t) * self.tracker.bias

    def reset(self) -> None:
        self.tracker.reset()
