"""State, reward, and the incremental environment for the repartitioning DQN.

The port's own copy of ``repro.core.rl.env``: the feature layout (``2 + 2m``
binned features, m = 8), the bin tables and sentinels, the ET-scalarized
reward, :func:`state_features` (the observation the greedy agent acts on) and
the incremental :class:`RepartitionEnv` over the event-driven engine, plus
:func:`inv_mean_durations`, the per-job coefficient the batched env and the
on-device trainer read, and the fleet-aware observation
(:func:`fleet_state_features`).  ``make_batched_env`` is not copied; the
port's :class:`repro_torch.core.batched.BatchedRepartitionEnv` is built
directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.slices import ALL_SLICE_SIZES

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.metrics import SimResult
    from repro_torch.core.simulator import MIGSimulator
    from repro_torch.fleet.simulator import FleetView

__all__ = [
    "M_JOBS",
    "FEATURE_DIM",
    "FLEET_EXTRA_FEATURES",
    "FLEET_FEATURE_DIM",
    "state_features",
    "fleet_state_features",
    "RewardWeights",
    "RepartitionEnv",
    "inv_mean_durations",
]

# The paper uses m=3 (§IV-D-1); the same load-driven analysis on the §V-A
# calibration selects m=8, in the paper's 2+2m layout.
M_JOBS = 8
FEATURE_DIM = 2 + 2 * M_JOBS

# Bin edges (minutes) for deadline slack and average duration.
_BIN_EDGES = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0])
_NUM_BINS = len(_BIN_EDGES) + 1  # 10 bins
_TIME_BINS = 48  # half-hour bins over the day


def _bin(v: float) -> int:
    return int(np.searchsorted(_BIN_EDGES, v, side="right"))


def state_features(t: float, sim: "MIGSimulator", m: int = M_JOBS) -> np.ndarray:
    """Normalized feature vector in [0, 1]^(2+2m); missing jobs -> 1.0/0.0."""
    feats: List[float] = []
    feats.append((sim.partition.config_id - 1) / 11.0)
    tod = (t / 60.0) % 24.0
    feats.append(int(tod * 2) % _TIME_BINS / (_TIME_BINS - 1))
    # first m jobs of the QUEUE in EDF order (paper §IV-D-1).  Padding with
    # running jobs would hide queue pressure — the "no job" sentinel pattern
    # is what lets the agent distinguish empty/loaded queues.
    jobs = sim.queue_snapshot()
    for i in range(m):
        if i < len(jobs):
            slack = max(jobs[i].deadline - t, 0.0)
            feats.append(_bin(slack) / (_NUM_BINS - 1))
            feats.append(_bin(jobs[i].mean_duration_all_sizes()) / (_NUM_BINS - 1))
        else:
            feats.append(1.0)  # "no job" sentinel: max slack
            feats.append(0.0)  # zero duration
    return np.asarray(feats, dtype=np.float32)


# Fleet-aware observation: the per-device features above plus two fleet
# signals read off the dispatch-time load trace (repro_torch.fleet.FleetView) —
# this device's share of the fleet backlog, and the normalized fleet-wide
# backlog.  The 2+2m core layout is unchanged, so a single-GPU policy can be
# warm-started by zero-padding and a fleet policy degrades gracefully when
# the fleet context is absent (both extras read 0.0).
FLEET_EXTRA_FEATURES = 2
FLEET_FEATURE_DIM = FEATURE_DIM + FLEET_EXTRA_FEATURES


def fleet_state_features(
    t: float,
    sim: "MIGSimulator",
    device_index: int,
    view: "FleetView | None",
    m: int = M_JOBS,
) -> np.ndarray:
    """Per-device observation inside a fleet, in [0, 1]^FLEET_FEATURE_DIM."""
    base = state_features(t, sim, m)
    if view is None:
        share, pressure = 0.0, 0.0
    else:
        share = view.load_share(device_index, t)
        pressure = view.total_load_norm(t)
    return np.concatenate(
        [base, np.asarray([share, pressure], dtype=np.float32)]
    )


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


class _CadenceTimer:
    """Timer-only pseudo-policy: opens decision points on a fixed clock.

    Interactive engines never call ``decide`` — the timer chain exists only
    to pause :class:`RepartitionEnv` at ``t = k * interval``, the decision
    cadence of the batched env (docs/BATCHED_SIM.md §5).
    """

    def __init__(self, interval_min: float) -> None:
        self.interval = float(interval_min)

    def decide(self, t, sim):  # pragma: no cover - interactive engines skip it
        return None

    def next_timer(self, t: float) -> float:
        return (math.floor(t / self.interval + 1e-9) + 1.0) * self.interval


class RepartitionEnv:
    """Incremental repartitioning environment (Gym-style, §IV-D).

    One episode is one simulated day (or any job stream): ``reset`` builds a
    fresh simulator + interactive :class:`SimulationEngine` and advances to
    the first decision point; ``step(action)`` applies the configuration
    choice, resumes the event loop to the next decision point (or the end of
    the stream), and returns the per-decision reward — the ET-scalarized
    energy/tardiness accumulated over exactly that interval, minus the
    §IV-D-3 switch penalty when the action repartitioned.

    ``step`` returns ``(obs, reward, terminated, truncated, info)``.
    ``truncate_after_min`` / ``max_decisions`` bound an episode early
    (curriculum / wall-clock control): the episode ends with
    ``truncated=True`` and the remaining simulated day is abandoned.

    Actions are config indices ``0..11`` mapping to configurations
    ``1..12`` (the paper's A100 Fig. 1 table); choosing the current
    configuration is a no-op decision.

    ``decision_interval_min`` switches the env from per-event decisions
    (default, the paper's §IV-D cadence) to the fixed clock the batched
    env uses: decisions happen only at ``t = 0, I, 2I, ...`` — event
    decision points in between are auto-held — and an episode ends at the
    first boundary past the last completion.  This is the oracle side of
    the batch-of-1 parity property.
    """

    def __init__(
        self,
        scheduler_name: str = "EDF-SS",
        spec=None,
        scenario: Optional[str] = None,
        scenario_kwargs: Optional[Dict] = None,
        rewards: RewardWeights = RewardWeights(),
        initial_config: int = 2,
        mig_enabled: bool = True,
        truncate_after_min: Optional[float] = None,
        max_decisions: Optional[int] = None,
        m: int = M_JOBS,
        repartition_mode: str = "partial",
        decision_interval_min: Optional[float] = None,
    ) -> None:
        from repro_torch.core.workload import WorkloadSpec

        self.spec = spec or WorkloadSpec()
        self.scenario = scenario
        self.scenario_kwargs = dict(scenario_kwargs or {})
        self.scheduler_name = scheduler_name
        self.rewards = rewards
        self.initial_config = initial_config
        self.mig_enabled = mig_enabled
        # "partial" (slot-placed transitions) or "drain" (legacy full drain);
        # the agent trains against whichever physics it will be evaluated on
        self.repartition_mode = repartition_mode
        self.truncate_after_min = truncate_after_min
        self.max_decisions = max_decisions
        self.m = m
        if decision_interval_min is not None and decision_interval_min <= 0:
            raise ValueError(
                f"decision_interval_min={decision_interval_min} must be positive"
            )
        self.decision_interval_min = decision_interval_min
        self.sim: "MIGSimulator | None" = None
        self.engine = None
        self._prev_energy = 0.0
        self._prev_tard = 0.0
        self._decisions = 0
        self._terminated = True
        self._at_t0 = False

    # ------------------------------------------------------------------
    def reset(self, seed: int = 0, jobs=None) -> np.ndarray:
        """Start a fresh episode; returns the first observation.

        ``jobs`` overrides the generated stream (otherwise the scenario or
        :class:`WorkloadSpec` is drawn with ``seed``).
        """
        from repro_torch.core.engine import SimulationEngine
        from repro_torch.core.scenarios import generate_scenario
        from repro_torch.core.schedulers import make_scheduler
        from repro_torch.core.simulator import MIGSimulator
        from repro_torch.core.workload import generate_jobs

        if jobs is None:
            if self.scenario is not None:
                jobs = generate_scenario(self.scenario, seed=seed, **self.scenario_kwargs)
            else:
                jobs = generate_jobs(self.spec, seed=seed)
        self.sim = MIGSimulator(
            make_scheduler(self.scheduler_name),
            mig_enabled=self.mig_enabled,
            repartition_mode=self.repartition_mode,
        )
        cadence = self.decision_interval_min
        self.engine = SimulationEngine(
            self.sim,
            policy=None if cadence is None else _CadenceTimer(cadence),
            interactive=True,
            initial_config=self.initial_config,
            jobs=jobs,
        )
        self._prev_energy = 0.0
        self._prev_tard = 0.0
        self._decisions = 0
        if cadence is None:
            self._terminated = not self.engine.run_to_decision()
        else:
            # cadence grid starts at t = 0: the first observation/action pair
            # happens before any event, exactly like the batched env's reset
            self._at_t0 = True
            self._terminated = False
        return self._obs()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        """Apply ``action`` at the pending decision point and advance."""
        if self.engine is None or self._terminated:
            raise RuntimeError("episode over (or never started); call reset()")
        sim = self.sim
        config_id = int(action) + 1  # actions 0..11 -> configs 1..12
        switched = config_id != sim.partition.config_id
        penalty = (
            self.rewards.switch_penalty(len(sim.active)) if switched else 0.0
        )
        if self._at_t0:
            # cadence mode, first decision: nothing has run yet, so there is
            # no pending interactive decision — apply the switch directly
            self._at_t0 = False
            if switched:
                self.engine.reconfigure(config_id)
        else:
            self.engine.provide_decision(config_id if switched else None)
        self._decisions += 1

        running = (
            self.engine.run_to_decision()
            if self.decision_interval_min is None
            else self._run_to_cadence_decision()
        )
        terminated = not running
        truncated = False
        if running:
            if (
                self.truncate_after_min is not None
                and sim.t >= self.truncate_after_min
            ):
                truncated = True
            if self.max_decisions is not None and self._decisions >= self.max_decisions:
                truncated = True
        self._terminated = terminated or truncated

        d_e = sim.energy_wh - self._prev_energy
        d_t = sim.tardiness_integral - self._prev_tard
        self._prev_energy = sim.energy_wh
        self._prev_tard = sim.tardiness_integral
        reward = self.rewards.interval_reward(d_e, d_t) - penalty

        info = {
            "t": sim.t,
            "switched": switched,
            "config_id": sim.partition.config_id,
            "decisions": self._decisions,
            # same O(1) definition as SimSnapshot/EngineEvent (not the
            # EDF-sorted queue_snapshot(): this runs in the training hot loop)
            "queue_depth": max(len(sim.active) - len(sim.assignment), 0),
        }
        return self._obs(), reward, terminated, truncated, info

    def _run_to_cadence_decision(self) -> bool:
        """Advance to the next ``k * interval`` pause; False when drained.

        Event decision points between boundaries are auto-held (the chosen
        configuration persists — the batched env's held-target semantics).
        A boundary timer firing after the system has fully drained is the
        episode's end, not a decision: the batched env terminates a rollout
        at the first boundary past its last completion, and so does this.
        """
        eng = self.engine
        while eng.run_to_decision():
            if not eng.awaiting_timer:
                eng.provide_decision(None)
                continue
            if (
                eng.arrivals_pending == 0
                and not eng.stream_open
                and not self.sim.active
            ):
                eng.provide_decision(None)
                continue
            return True
        return False

    @property
    def done(self) -> bool:
        """True when no episode is in progress (terminated or truncated)."""
        return self._terminated

    def result(self) -> "SimResult":
        """The finished episode's :class:`SimResult` (terminal episodes only)."""
        if self.engine is None:
            raise RuntimeError("no episode has run")
        return self.engine.result()

    def _obs(self) -> np.ndarray:
        return state_features(self.sim.t, self.sim, self.m)


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
