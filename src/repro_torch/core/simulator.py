"""Event-driven MIG simulator with preemption and dynamic repartitioning.

Implements the paper's simulation setting (§IV, §V-A):

* events: job arrival, job completion, critical-laxity timer (LLF/LALF),
  repartition-complete, and policy timer (Day/Night benchmark boundaries);
* at arrival/completion the repartitioning policy may choose a new
  configuration (paper §IV-D-2 "event-based architecture"); repartitioning
  charges the 4-second §IV-D-3 stall.  Under the default
  ``repartition_mode="partial"`` only the slice instances that actually
  change are destroyed/created (:func:`repro_torch.core.slices.transition`) —
  jobs on surviving instances keep running through the stall, exactly as a
  real MIG reconfiguration leaves untouched GPU instances operational.
  ``repartition_mode="drain"`` is the legacy full-drain model (every
  running job preempted, the whole GPU blocked), kept so pre-``mig-sim-4``
  numbers stay reproducible;
* between consecutive events the set of running jobs is constant, so energy
  (Fig. 3 power curve) and the tardiness integral are integrated exactly;
* preemptions are counted by diffing consecutive assignments (a running job
  that is paused or moved counts once).

The event loop itself lives in :mod:`repro_torch.core.engine`
(:class:`SimulationEngine`): :meth:`MIGSimulator.run` is a thin one-shot
wrapper over it, and the step-wise path is bit-identical by construction.
This module keeps the numeric state — time advance, energy/tardiness
integration, assignments, preemption accounting — and the policy zoo.

The simulator is deterministic given the job list and policy.

The port's own copy of ``repro.core.simulator`` (all of it but the list of
jobs the service layer's ``cancel`` removes): the batched simulator
(:mod:`repro_torch.core.batched`) reads its constants and closed-form
policies, the evaluation path (:mod:`repro_torch.core.rl.train`,
:mod:`repro_torch.sweep.cells`) runs :class:`MIGSimulator`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Protocol, Sequence, Tuple

from repro_torch.core.engine import SimSnapshot, SimulationEngine, snapshot_of
from repro_torch.core.jobs import Job
from repro_torch.core.metrics import SimResult
from repro_torch.core.power import A100_250W, PowerModel
from repro_torch.core.schedulers import Assignment, Scheduler, remap_assignment
from repro_torch.core.slices import MIG_CONFIGS, Partition, table_slice_sizes, transition

__all__ = [
    "RepartitionPolicy",
    "StaticPolicy",
    "NoMIGPolicy",
    "DayNightPolicy",
    "CallbackPolicy",
    "MIGSimulator",
    "REPARTITION_PENALTY_MIN",
    "REPARTITION_MODES",
    "SIM_VERSION",
]

# Version tag of the simulation semantics: the reference's, which this copy
# and the port's batched step reproduce.
#
# mig-sim-4: partitions are slot-placed and repartitioning is partial by
# default — only the slice instances that change are destroyed/created,
# jobs on surviving instances run through the 4 s stall, and the stall is
# charged against the affected slots only (repartition_mode="drain" restores
# the mig-sim-3 full-drain numbers bit-identically).
SIM_VERSION = "mig-sim-4"

# §IV-D-3: destroying/recreating MIG slices takes ~4 seconds.
REPARTITION_PENALTY_MIN = 4.0 / 60.0

#: valid ``MIGSimulator.repartition_mode`` values: ``"partial"`` (slot-placed
#: transition, survivors keep running) and ``"drain"`` (legacy full drain).
REPARTITION_MODES = ("partial", "drain")

_EPS = 1e-9


class RepartitionPolicy(Protocol):
    """Decides the MIG configuration at decision points."""

    initial_config: int

    def decide(self, t: float, sim: "MIGSimulator") -> Optional[int]:
        """Return a config id to switch to, or None to stay."""
        ...

    def next_timer(self, t: float) -> Optional[float]:
        """Next time-triggered decision point strictly after ``t`` (or None)."""
        ...


class StaticPolicy:
    """Fixed configuration; never repartitions (Static MIG benchmark)."""

    def __init__(self, config_id: int) -> None:
        self.initial_config = config_id

    def decide(self, t: float, sim: "MIGSimulator") -> Optional[int]:
        return None

    def next_timer(self, t: float) -> Optional[float]:
        return None


class NoMIGPolicy(StaticPolicy):
    """Full GPU, MIG disabled (No MIG benchmark).

    Config 1 (one 7g.40gb slice) with ``mig_enabled=False`` so that linear
    jobs get the §V-A 6 % full-GPU speedup.
    """

    def __init__(self) -> None:
        super().__init__(config_id=1)


class DayNightPolicy:
    """Twice-daily repartitioning benchmark (§V-A).

    Config ``day_config`` during 5:00-17:00, ``night_config`` otherwise.
    """

    def __init__(self, day_config: int = 6, night_config: int = 2) -> None:
        self.day_config = day_config
        self.night_config = night_config
        self.day_start = 5 * 60.0
        self.day_end = 17 * 60.0
        self.initial_config = self._target(0.0)

    def _target(self, t: float) -> int:
        tod = t % (24 * 60.0)
        return (
            self.day_config
            if self.day_start <= tod < self.day_end
            else self.night_config
        )

    def decide(self, t: float, sim: "MIGSimulator") -> Optional[int]:
        tgt = self._target(t)
        return tgt if tgt != sim.partition.config_id else None

    def next_timer(self, t: float) -> Optional[float]:
        day = 24 * 60.0
        base = math.floor(t / day) * day
        for bound in (base + self.day_start, base + self.day_end,
                      base + day + self.day_start):
            if bound > t + _EPS:
                return bound
        return None  # pragma: no cover


class CallbackPolicy:
    """Adapter: wraps a ``(t, sim) -> Optional[int]`` callable (RL agent)."""

    def __init__(
        self,
        fn,
        initial_config: int = 2,
    ) -> None:
        self._fn = fn
        self.initial_config = initial_config

    def decide(self, t: float, sim: "MIGSimulator") -> Optional[int]:
        return self._fn(t, sim)

    def next_timer(self, t: float) -> Optional[float]:
        return None


class MIGSimulator:
    """One GPU (or TPU-pod analogue), one scheduler, one repartition policy."""

    def __init__(
        self,
        scheduler: Scheduler,
        power_model: PowerModel = A100_250W,
        mig_enabled: bool = True,
        repartition_penalty_min: float = REPARTITION_PENALTY_MIN,
        max_events: int = 5_000_000,
        config_table: Optional[Mapping[int, Partition]] = None,
        repartition_mode: str = "partial",
    ) -> None:
        if repartition_mode not in REPARTITION_MODES:
            raise ValueError(
                f"unknown repartition_mode {repartition_mode!r}; "
                f"valid: {REPARTITION_MODES}"
            )
        self.scheduler = scheduler
        self.power = power_model
        self.mig_enabled = mig_enabled
        self.penalty = repartition_penalty_min
        self.max_events = max_events
        self.repartition_mode = repartition_mode
        # per-device partition table (fleet heterogeneity): defaults to the
        # paper's A100 Fig. 1 table, under which behavior is unchanged
        self.configs: Mapping[int, Partition] = (
            dict(config_table) if config_table is not None else MIG_CONFIGS
        )
        # device slot-grid geometry, cached for snapshot fragmentation:
        # the grid is as wide as the widest layout in the table, and the
        # placeable vocabulary is whatever slice widths the table uses
        self.grid_slots: int = max(p.total_slots for p in self.configs.values())
        self.slice_sizes: Tuple[int, ...] = table_slice_sizes(dict(self.configs))

        # runtime state (reset per run)
        self.reset(min(self.configs))

    def reset(self, config_id: int) -> None:
        """Clear all run state and install the initial configuration.

        :class:`~repro_torch.core.engine.SimulationEngine` calls this when it is
        constructed; a simulator instance is reusable across runs.
        """
        self.t = 0.0
        self.partition: Partition = self._config(config_id)
        self.active: Dict[int, Job] = {}
        self.assignment: Assignment = {}
        self.completed: List[Job] = []
        self.energy_wh = 0.0
        self.tardiness_integral = 0.0
        self.preemptions = 0
        self.repartitions = 0
        self.busy_slot_minutes = 0.0
        self.util_histogram: Dict[int, float] = {}
        self.config_trace: List[Tuple[float, int]] = [(0.0, config_id)]
        self._repartitioning_until: Optional[float] = None
        self._pending_config: Optional[int] = None
        # partial-repartition state: surviving old->new slice index map and
        # the slot footprint of the in-flight rebuild (0 when idle)
        self._survivor_map: Dict[int, int] = {}
        self._stalled_slots: int = 0

    # ------------------------------------------------------------------
    def _config(self, config_id: int) -> Partition:
        try:
            return self.configs[config_id]
        except KeyError as e:
            raise KeyError(
                f"config {config_id} not in this device's table "
                f"(valid ids {sorted(self.configs)})"
            ) from e

    @property
    def busy_slots(self) -> float:
        """Compute slots currently doing work.

        During a repartition the assignment holds exactly the surviving
        jobs (all of them in drain mode: none), so summing the assignment
        is correct in every state — the stall is charged only against the
        affected slots, survivors keep drawing busy power.
        """
        return float(
            sum(self.partition.slices[s].slots for s in self.assignment.values())
        )

    @property
    def stalled_slots(self) -> int:
        """Slot footprint of the in-flight repartition (0 when idle)."""
        return self._stalled_slots if self._repartitioning_until is not None else 0

    def queue_snapshot(self) -> List[Job]:
        """Waiting (unassigned, incomplete) jobs sorted EDF-style."""
        waiting = [
            j for j in self.active.values() if not j.done and j.job_id not in self.assignment
        ]
        waiting.sort(key=lambda j: (j.deadline, j.arrival, j.job_id))
        return waiting

    def snapshot(self) -> SimSnapshot:
        """Structured read-only view of the current state.

        This is what repartitioning policies and fleet dispatchers observe
        (see :class:`repro_torch.core.engine.SimSnapshot` for the field contract);
        everything in it is observable by a real MIG controller.
        """
        return snapshot_of(self)

    # ------------------------------------------------------------------
    def _advance(self, new_t: float) -> None:
        dt = new_t - self.t
        if dt < -1e-6:
            raise RuntimeError(f"time went backwards: {self.t} -> {new_t}")
        if dt <= 0.0:
            self.t = new_t
            return
        busy = self.busy_slots
        self.energy_wh += self.power.energy_wh(busy, dt)
        self.busy_slot_minutes += busy * dt
        self.util_histogram[int(round(busy))] = (
            self.util_histogram.get(int(round(busy)), 0.0) + dt
        )
        # exact tardiness integral: each incomplete job past its deadline
        # contributes the overlap of [t, new_t] with [deadline, inf)
        for job in self.active.values():
            if not job.done and job.deadline < new_t:
                self.tardiness_integral += new_t - max(job.deadline, self.t)
        # deplete running jobs
        for jid, sl in self.assignment.items():
            job = self.active[jid]
            rate = job.rate_on(self.partition.slices[sl].slots, self.mig_enabled)
            job.remaining = max(job.remaining - rate * dt, 0.0)
        self.t = new_t

    def _complete_finished(self) -> List[Job]:
        done = []
        for jid in list(self.assignment):
            job = self.active[jid]
            if job.remaining <= _EPS:
                job.remaining = 0.0
                job.completion = self.t
                done.append(job)
                del self.assignment[jid]
                del self.active[jid]
                self.completed.append(job)
        # zero-remaining jobs that never held a slice (e.g. an injected
        # zero-/epsilon-work arrival): schedulers skip done jobs, so without
        # this sweep they would sit in `active` forever and drain() on a
        # closed stream would never finish.  No job in the assignment-driven
        # path above ever reaches here, so legacy runs are bit-identical.
        for jid, job in list(self.active.items()):
            if job.remaining <= _EPS and jid not in self.assignment:
                job.remaining = 0.0
                job.completion = self.t
                done.append(job)
                del self.active[jid]
                self.completed.append(job)
        return done

    def _apply_assignment(self, new: Assignment) -> None:
        for jid, old_slice in self.assignment.items():
            if jid not in new or new[jid] != old_slice:
                self.preemptions += 1
                self.active[jid].preemptions += 1
        for jid, sl in new.items():
            self.active[jid].last_slice = sl
        self.assignment = dict(new)

    def _reschedule(self) -> None:
        if self._repartitioning_until is not None:
            return
        jobs = [j for j in self.active.values() if not j.done]
        new = self.scheduler.assign(
            self.t, self.partition, jobs, self.assignment, self.mig_enabled
        )
        # drop stale ids defensively
        new = {jid: s for jid, s in new.items() if jid in self.active}
        self._apply_assignment(new)

    def _start_repartition(self, config_id: int) -> None:
        new_part = self._config(config_id)
        if self.repartition_mode == "partial":
            plan = transition(self.partition, new_part)
            survivors = plan.survivor_map
            self._stalled_slots = plan.stalled_slots
        else:  # drain: every slice is torn down, the whole GPU stalls
            survivors = {}
            self._stalled_slots = self.partition.total_slots
        # only jobs on destroyed slices are preempted back to the queue;
        # jobs on surviving slice instances keep running through the stall
        for jid, sl in list(self.assignment.items()):
            if sl not in survivors:
                self.preemptions += 1
                self.active[jid].preemptions += 1
                del self.assignment[jid]
        self._survivor_map = survivors
        self._pending_config = config_id
        self._repartitioning_until = self.t + self.penalty
        self.repartitions += 1

    def _finish_repartition(self) -> None:
        assert self._pending_config is not None
        self.partition = self._config(self._pending_config)
        if self.assignment:
            # survivors keep their physical slice under the new numbering —
            # identity-stable, so the preemption diff sees no move
            self.assignment = remap_assignment(self.assignment, self._survivor_map)
            for jid, sl in self.assignment.items():
                self.active[jid].last_slice = sl
        self.config_trace.append((self.t, self.partition.config_id))
        self._pending_config = None
        self._repartitioning_until = None
        self._survivor_map = {}
        self._stalled_slots = 0

    # ------------------------------------------------------------------
    def run(
        self,
        jobs: Sequence[Job],
        policy: Optional[RepartitionPolicy] = None,
        initial_config: Optional[int] = None,
    ) -> SimResult:
        """Simulate to completion of all jobs; returns a :class:`SimResult`.

        One-shot wrapper over :class:`repro_torch.core.engine.SimulationEngine`;
        build the engine directly for step-wise execution, online arrival
        injection, or a live trace sink.
        """
        engine = SimulationEngine(
            self, policy=policy, initial_config=initial_config, jobs=jobs
        )
        engine.drain()
        return engine.result()
