"""Vectorized repartitioning environment over the port's batched backend.

:class:`BatchedRepartitionEnv` is the port of ``repro.core.batched.env``:
one ``reset`` builds ``B`` independent episodes (one per seed) and every
``step`` applies a *vector* of configuration actions, advancing all episodes
one decision interval through :func:`~repro_torch.core.batched.backend.run_steps`
on the device.

Contract (docs/BATCHED_SIM.md §5, as the reference's):

* decisions happen on a fixed cadence (``decision_interval_min``) and the
  chosen configuration is held in between (:func:`held_policy`);
* observations use the §IV-D-1 feature layout (2+2m binned features, the
  bin edges and sentinels of :mod:`repro_torch.core.rl.env`), computed on
  the host from a copy of the carry, in numpy;
* rewards are the ET-scalarized interval rewards with the §IV-D-3 switch
  penalty, per rollout, in float64 on the host.

Only EDF-FS is available (the one scheduler the batched backend implements).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batched.backend import (
    DEFAULT_DT_MIN,
    device_constants,
    init_state,
    result_of,
    run_steps,
)
from repro_torch.core.batched.policies import held_policy
from repro_torch.core.batched.state import BatchedJobs
from repro_torch.core.batched.tables import DeviceTables, build_tables
from repro_torch.core.metrics import SimResult
from repro_torch.core.rl.env import (
    _BIN_EDGES,
    _NUM_BINS,
    _TIME_BINS,
    M_JOBS,
    RewardWeights,
    inv_mean_durations,
)
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["BatchedRepartitionEnv"]

_EPS = 1e-6


class BatchedRepartitionEnv:
    """Gym-style vectorized env: ``(B,)`` actions in, ``(B,)`` rewards out.

    Actions are config indices ``0..C-1`` mapping to configuration ids
    ``1..C`` (the paper's Fig. 1 table by default); choosing the current
    configuration is a no-op.  ``step`` returns
    ``(obs (B, 2+2m), reward (B,), terminated (B,), truncated (B,), info)``.
    The rollouts live on ``device`` (default: the CUDA card; ``"cpu"`` on
    request).
    """

    def __init__(
        self,
        scheduler_name: str = "EDF-FS",
        scenario: Optional[str] = None,
        scenario_kwargs: Optional[Dict[str, Any]] = None,
        spec=None,
        rewards: RewardWeights = RewardWeights(),
        initial_config: int = 2,
        mig_enabled: bool = True,
        repartition_mode: str = "partial",
        decision_interval_min: float = 15.0,
        dt_min: float = DEFAULT_DT_MIN,
        truncate_after_min: Optional[float] = None,
        max_decisions: Optional[int] = None,
        m: int = M_JOBS,
        tables: Optional[DeviceTables] = None,
        device: DeviceLike = None,
    ) -> None:
        if scheduler_name != "EDF-FS":
            raise ValueError(
                f"batched env supports only EDF-FS (got {scheduler_name!r}); "
                "use repro.core.rl.env.RepartitionEnv for other schedulers"
            )
        steps = decision_interval_min / dt_min
        if abs(round(steps) - steps) > 1e-9 or round(steps) < 1:
            raise ValueError(
                f"decision_interval_min={decision_interval_min} must be a "
                f"positive multiple of dt_min={dt_min}"
            )
        from repro_torch.core.workload import WorkloadSpec

        self.device = resolve_device(device)
        self.spec = spec or WorkloadSpec()
        self.scenario = scenario
        self.scenario_kwargs = dict(scenario_kwargs or {})
        self.rewards = rewards
        self.initial_config = initial_config
        self.mig_enabled = mig_enabled
        self.repartition_mode = repartition_mode
        self.dt_min = float(dt_min)
        self.steps_per_decision = int(round(steps))
        self.truncate_after_min = truncate_after_min
        self.max_decisions = max_decisions
        self.m = m
        self.tables = tables if tables is not None else build_tables()
        self._consts = device_constants(self.tables, repartition_mode, self.device)
        self._state = None
        self._jobs: Optional[BatchedJobs] = None
        self._inv_mean_dur: Optional[np.ndarray] = None
        self._t = 0.0
        self._decisions = 0
        self._halted: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def reset(
        self,
        seeds: Sequence[int] = (0,),
        job_lists: Optional[Sequence[Sequence[Any]]] = None,
    ) -> np.ndarray:
        """Start ``B`` fresh episodes; returns the ``(B, 2+2m)`` observation.

        ``seeds`` draws one job stream per rollout from the scenario (or
        :class:`WorkloadSpec`); ``job_lists`` overrides them directly.
        """
        from repro_torch.core.scenarios import generate_scenario
        from repro_torch.core.workload import generate_jobs

        if job_lists is None:
            if self.scenario is not None:
                job_lists = [
                    generate_scenario(self.scenario, seed=s, **self.scenario_kwargs)
                    for s in seeds
                ]
            else:
                job_lists = [generate_jobs(self.spec, seed=s) for s in seeds]
        self._jobs = BatchedJobs.from_job_lists(
            job_lists, max_slots=self.tables.max_slots,
            mig_enabled=self.mig_enabled,
        )
        B, J = self._jobs.arrival.shape
        self._inv_mean_dur = inv_mean_durations(job_lists, (B, J), np.float64)
        init_idx = np.full((B,), self.tables.index_of(self.initial_config),
                           dtype=np.int32)
        self._state = init_state(self._jobs, init_idx, self.device)
        self._t = 0.0
        self._decisions = 0
        self._halted = np.zeros((B,), dtype=bool)
        return self._obs()

    def step(
        self, actions: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        """Apply per-rollout actions and advance one decision interval."""
        if self._state is None or self._jobs is None:
            raise RuntimeError("call reset() first")
        if self.done:
            raise RuntimeError("all episodes over; call reset()")
        acts = np.asarray(actions, dtype=np.int64)
        B = self._jobs.batch
        if acts.shape != (B,):
            raise ValueError(f"actions shape {acts.shape} != ({B},)")
        config_ids = np.asarray(self.tables.config_ids)
        if acts.min() < 0 or acts.max() >= len(config_ids):
            raise ValueError(
                f"actions must be in [0, {len(config_ids) - 1}]"
            )
        targets = acts.astype(np.int32)  # dense index == id-1 for Fig. 1
        cur = self._state.cfg.cpu().numpy()
        switched = targets != cur
        # §IV-D-3 switch penalty, priced on the jobs currently in system
        remaining = self._state.remaining.cpu().numpy()
        arrived = np.asarray(self._jobs.arrival) <= self._t + _EPS
        in_sys = (arrived & (remaining > _EPS) & self._jobs.valid).sum(axis=1)
        w = self.rewards
        pen_y = w.switch_penalty_min * np.maximum(in_sys, 1) / w.tardiness_norm
        penalty = np.where(switched, (pen_y / (w.a + 1.0)) / w.scale, 0.0)

        e0 = self._state.energy_wh.cpu().numpy().astype(np.float64)
        td0 = self._state.tardiness_integral.cpu().numpy().astype(np.float64)
        self._state = run_steps(
            self._state, self._jobs, held_policy(targets, cur), self._consts,
            t0_min=self._t, n_steps=self.steps_per_decision,
            dt_min=self.dt_min, penalty_min=self.tables.penalty_min,
        )
        self._t += self.steps_per_decision * self.dt_min
        self._decisions += 1

        d_e = self._state.energy_wh.cpu().numpy().astype(np.float64) - e0
        d_t = self._state.tardiness_integral.cpu().numpy().astype(np.float64) - td0
        reward = w.interval_reward(d_e, d_t) - penalty

        stop = self._state.stop_time.cpu().numpy()
        terminated = stop <= self._t + _EPS
        truncated = np.zeros_like(terminated)
        if self.truncate_after_min is not None and self._t >= self.truncate_after_min:
            truncated = ~terminated
        if self.max_decisions is not None and self._decisions >= self.max_decisions:
            truncated = ~terminated
        self._halted = terminated | truncated

        cfg = self._state.cfg.cpu().numpy()
        info = {
            "t": self._t,
            "switched": switched,
            "config_id": config_ids[cfg],
            "decisions": self._decisions,
            "queue_depth": np.maximum(
                in_sys - (self._state.slice_job.cpu().numpy() >= 0).sum(axis=1),
                0,
            ),
        }
        return self._obs(), reward, terminated, truncated, info

    @property
    def done(self) -> bool:
        """True once every rollout has terminated or been truncated."""
        return self._halted is not None and bool(self._halted.all())

    def results(self) -> List[SimResult]:
        """Per-rollout :class:`SimResult` (meaningful for terminated rollouts)."""
        if self._state is None or self._jobs is None:
            raise RuntimeError("no episode has run")
        return result_of(self._state, self._jobs, self.tables).to_sim_results()

    # ------------------------------------------------------------------
    def _obs(self) -> np.ndarray:
        """§IV-D-1 features per rollout: config, time, m×(slack, duration)."""
        jobs = self._jobs
        state = self._state
        assert jobs is not None and state is not None
        t = self._t
        B, J = jobs.arrival.shape
        remaining = state.remaining.cpu().numpy().astype(np.float64)
        slice_job = state.slice_job.cpu().numpy()
        cfg_ids = np.asarray(self.tables.config_ids)[state.cfg.cpu().numpy()]
        arrival = np.asarray(jobs.arrival, dtype=np.float64)
        deadline = np.asarray(jobs.deadline, dtype=np.float64)

        running = np.zeros((B, J), dtype=bool)
        rows, lanes = np.nonzero(slice_job >= 0)
        running[rows, slice_job[rows, lanes]] = True

        obs = np.zeros((B, 2 + 2 * self.m), dtype=np.float32)
        obs[:, 0] = (cfg_ids - 1) / 11.0
        tod = (t / 60.0) % 24.0
        obs[:, 1] = int(tod * 2) % _TIME_BINS / (_TIME_BINS - 1)
        queued = (
            (arrival <= t + _EPS) & (remaining > _EPS)
            & (~running) & jobs.valid
        )
        for b in range(B):
            idx = np.flatnonzero(queued[b])
            # EDF order; stable sort keeps (arrival, job_id) tie order
            idx = idx[np.argsort(deadline[b, idx], kind="stable")]
            for i in range(self.m):
                if i < len(idx):
                    j = idx[i]
                    slack = max(deadline[b, j] - t, 0.0)
                    mean_dur = remaining[b, j] * self._inv_mean_dur[b, j]
                    obs[b, 2 + 2 * i] = (
                        np.searchsorted(_BIN_EDGES, slack, side="right")
                        / (_NUM_BINS - 1)
                    )
                    obs[b, 3 + 2 * i] = (
                        np.searchsorted(_BIN_EDGES, mean_dur, side="right")
                        / (_NUM_BINS - 1)
                    )
                else:
                    obs[b, 2 + 2 * i] = 1.0  # "no job" sentinel: max slack
                    obs[b, 3 + 2 * i] = 0.0
        return obs
