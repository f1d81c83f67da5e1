"""Steppable event engine behind the MIG simulator (paper §IV-D-2).

:class:`SimulationEngine` is the reference's event loop, which one can pause,
observe and resume:

* ``step()`` processes exactly one event (arrival, completion,
  critical-laxity timer, repartition-complete, policy timer) and returns an
  :class:`EngineEvent` record, or ``None`` when the event queue is empty;
* ``run_until(t)`` processes every pending event up to a time bound;
* ``inject(job)`` feeds an arrival into a *running* engine (the engine is
  constructed with ``stream_open=True`` and the producer calls
  ``close_stream()`` when the stream ends);
* ``snapshot()`` returns the read-only :class:`EngineSnapshot` view that
  policies consume;
* in *interactive* mode the engine stops at each §IV-D decision point and
  waits for :meth:`provide_decision` instead of consulting a policy — the
  incremental RL environment (:class:`repro_torch.core.rl.env.RepartitionEnv`)
  is built on exactly this;
* a ``trace_sink`` callable receives every :class:`EngineEvent` as it is
  processed.

``MIGSimulator.run()`` is a thin wrapper, so one-shot and step-wise
execution share this code path.  This engine is the bit-exact oracle the
batched backend (:mod:`repro_torch.core.batched`) is held against within
documented tolerances.  All numeric state (time advance, energy/tardiness
integration, preemption accounting) stays on the
:class:`~repro_torch.core.simulator.MIGSimulator`; the engine owns only the
event queue, the event versioning, and decision-point sequencing.

The port's own copy of ``repro.core.engine``.  Heap entries, the tie-break
counter, the push order and every float operation are the reference's, so
the same jobs and policy give the same :class:`SimResult` bit for bit.
``cancel``, ``reconfigure`` and ``job_disposition`` are the service's ops
(:mod:`repro_torch.service`) and the fleet stream's; the engine pickles
whole (``to_snapshot_bytes`` / ``from_snapshot_bytes``) for the service's
checkpoints, and ``harvest_completed`` folds finished jobs out of it.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import math
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.core.jobs import Job, JobKind
from repro_torch.core.metrics import SimResult, TenantSLOStats
from repro_torch.core.slices import free_slot_geometry

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.simulator import MIGSimulator, RepartitionPolicy

__all__ = [
    "EventKind",
    "EngineEvent",
    "SimSnapshot",
    "EngineSnapshot",
    "TraceSink",
    "SimulationEngine",
]

_EPS = 1e-9


class EventKind(enum.IntEnum):
    """Event types, in heap tie-break priority order (lower pops first)."""

    ARRIVAL = 0
    COMPLETION = 1
    CRITICAL = 2
    REPART_DONE = 3
    TIMER = 4


@dataclasses.dataclass(frozen=True)
class EngineEvent:
    """One processed event — what ``step()`` returns and trace sinks see."""

    t: float
    kind: EventKind
    job_id: int  # -1 when the event carries no job payload
    decision: bool  # True when this event opened a §IV-D decision point
    config_id: int
    queue_depth: int


@dataclasses.dataclass(frozen=True)
class SimSnapshot:
    """Read-only observable state of one device at a point in time.

    Everything here is observable by a real MIG controller (job counts and
    outstanding work by class, current partition, an in-flight repartition)
    plus the run accumulators the reward/telemetry layers read.  Policies
    and dispatchers consume this instead of groping simulator internals.
    """

    # lint: waive[VG001] schema/version class attrs only; no event-loop semantics changed
    SCHEMA_VERSION = 1  # the reference's field set, version 1 (repro_torch.lint SD001/SD002)
    _schema_digest = "608ee2dd"  # pinned by repro_torch.lint; the reference's digest

    t: float
    config_id: int
    num_slices: int
    mig_enabled: bool
    repartitioning: bool
    repartition_remaining_min: float
    #: slot footprint of the in-flight repartition (0 when idle; the whole
    #: partition in drain mode).  The state-aware fleet dispatcher weights
    #: the repartition stall by this instead of writing off the device.
    stalled_slots: int
    #: slice indices of the current partition with a job running on them —
    #: what an opportunistic repartitioner checks before tearing an
    #: instance down (MIG-Serving-style displacement-free reconfiguration)
    occupied_slices: Tuple[int, ...]
    jobs_in_system: int
    active_jobs: int  # incl. depleted jobs not yet swept by completion
    queue_depth: int
    running: int
    completed_jobs: int
    busy_slots: float
    backlog_1g_min: float
    #: total depletion rate of the running set (1g-work/min): between events
    #: the backlog drains linearly at exactly this rate, so observers can
    #: project state to any instant before the next event without touching
    #: the simulation
    service_rate_1g_per_min: float
    inference_jobs: int
    inference_backlog_1g_min: float
    training_jobs: int
    training_backlog_1g_min: float
    energy_wh: float
    tardiness_integral: float
    preemptions: int
    repartitions: int
    #: free-slot geometry of the current partition (DESIGN.md §9): grid
    #: cells no occupied slice covers, the widest instance the device's
    #: table could still place there, and the fragmentation ratio
    #: ``1 - max_placeable/free`` (0 when nothing is free).  Forecast-style
    #: policies and the fragmentation-aware dispatcher read these instead
    #: of recomputing placement from ``occupied_slices``.
    free_slots: int = 0
    max_placeable_slots: int = 0
    fragmentation: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """:class:`SimSnapshot` plus the engine-level queue state."""

    SCHEMA_VERSION = 1  # the reference's field set, version 1 (repro_torch.lint SD001/SD002)
    _schema_digest = "12097506"

    sim: SimSnapshot
    next_event_time: Optional[float]
    pending_arrivals: int
    events_processed: int
    stream_open: bool
    awaiting_decision: bool


#: live telemetry consumer: called with every processed event
TraceSink = Callable[[EngineEvent], None]


class SimulationEngine:
    """The event loop of one :class:`MIGSimulator`, exposed step-wise.

    Parameters
    ----------
    sim:
        The simulator whose state this engine drives.  Constructing the
        engine **resets** the simulator's run state.
    policy:
        A :class:`RepartitionPolicy` consulted at decision points.  ``None``
        with ``interactive=False`` falls back to a static policy (config
        ``initial_config`` or 3, matching the historical ``run()`` default);
        ``None`` with ``interactive=True`` means the caller supplies every
        decision via :meth:`provide_decision`.
    jobs:
        Arrivals known up front (the one-shot path).  More can be fed later
        with :meth:`inject` while ``stream_open`` is True.
    stream_open:
        Declare that arrivals will be injected online.  Policy timers keep
        firing while the stream is open even if the system is momentarily
        empty; call :meth:`close_stream` when the producer is done.
    decision_hook:
        Fires ``(t, sim)`` at every decision point *before* the policy —
        observation-only (the EXPERIMENTS.md calibration analysis uses it).
    trace_sink:
        Receives every processed :class:`EngineEvent` (live telemetry).
    """

    def __init__(
        self,
        sim: "MIGSimulator",
        policy: Optional["RepartitionPolicy"] = None,
        *,
        initial_config: Optional[int] = None,
        jobs: Sequence[Job] = (),
        stream_open: bool = False,
        interactive: bool = False,
        decision_hook: Optional[Callable[[float, "MIGSimulator"], None]] = None,
        trace_sink: Optional[TraceSink] = None,
    ) -> None:
        if policy is None and not interactive:
            from repro_torch.core.simulator import StaticPolicy

            policy = StaticPolicy(config_id=initial_config or 3)
        self.sim = sim
        self.policy = policy
        self.interactive = interactive
        self.decision_hook = decision_hook
        self.trace_sink = trace_sink
        self.stream_open = stream_open

        if initial_config is not None:
            cfg0, cfg0_src = initial_config, "initial_config override"
        elif policy is not None:
            cfg0 = policy.initial_config
            cfg0_src = f"policy {type(policy).__name__}.initial_config"
        else:
            cfg0, cfg0_src = 3, "engine default"
        # validate against the device's table up front: an A100-space
        # initial config (e.g. CallbackPolicy's default 2) on a smaller
        # device must fail here with a clear message, not as a bare
        # KeyError deep inside the first _config() lookup mid-run
        if cfg0 not in sim.configs:
            raise ValueError(
                f"initial config {cfg0} (from {cfg0_src}) is not in this "
                f"device's partition table (valid ids {sorted(sim.configs)}); "
                "pass a valid initial_config or wrap the policy in "
                "repro_torch.fleet.DeviceAdaptedPolicy"
            )
        sim.reset(cfg0)

        self._seq = itertools.count()
        # (t, kind, seq, payload, version)
        self._heap: List[Tuple[float, int, int, int, int]] = []
        self._version = 0
        # pending policy-timer times; pruned on TIMER pop so multi-day
        # streaming runs don't grow memory with every timer ever scheduled
        self._timer_scheduled: set = set()
        self.events_processed = 0
        self._awaiting: Optional[Tuple[EventKind, int, bool]] = None

        # cancellation bookkeeping: ids cancelled before their arrival event
        # popped (the pop loop skips those), and every id ever cancelled
        self._cancelled_pending: set = set()
        self._cancelled_ids: set = set()
        # completed/cancelled jobs folded out by harvest_completed(), which
        # bounds a long-running service's memory; result() is then the
        # harvester's to compute
        self._harvested = 0

        self._jobs_by_id: Dict[int, Job] = {}
        self.arrivals_pending = 0
        for job in jobs:
            self._register(job)
        self._schedule_policy_timer()
        self._push_followups()

    # ------------------------------------------------------------------
    # event queue primitives

    def _push(self, t: float, kind: EventKind, payload: int = -1, ver: int = -1) -> None:
        heapq.heappush(self._heap, (t, int(kind), next(self._seq), payload, ver))

    def _register(self, job: Job) -> None:
        if job.job_id in self._jobs_by_id:
            raise ValueError(
                f"cannot inject job {job.job_id} at sim time t={self.sim.t}: "
                f"that job id was already injected; submit each job under a "
                f"unique id (resubmissions after a crash must reuse the old "
                f"id only if the original was never acknowledged)"
            )
        self._jobs_by_id[job.job_id] = job
        self.arrivals_pending += 1
        self._push(job.arrival, EventKind.ARRIVAL, job.job_id)

    def inject(self, job: Job) -> None:
        """Feed one arrival into a running engine (online streaming).

        The arrival may not lie in the engine's past: events up to
        ``job.arrival`` must not have been processed yet.  Requires an open
        stream — one-shot engines (constructed with a preloaded job list and
        ``stream_open=False``) and engines whose producer already called
        :meth:`close_stream` refuse injections.
        """
        if not self.stream_open:
            raise RuntimeError(
                f"cannot inject job {job.job_id} at sim time t={self.sim.t}: "
                f"the arrival stream is closed; construct the engine with "
                f"stream_open=True and inject before close_stream()"
            )
        if job.arrival < self.sim.t - 1e-6:
            raise ValueError(
                f"cannot inject job {job.job_id} with arrival t={job.arrival} "
                f"into an engine already at sim time t={self.sim.t}: events up "
                f"to its arrival were already processed; re-stamp the arrival "
                f"to >= {self.sim.t} (a live service should stamp arrivals "
                f"with max(client time, last advance bound))"
            )
        self._register(job)

    def close_stream(self) -> None:
        """Declare the online arrival stream finished (see ``stream_open``)."""
        self.stream_open = False

    # ------------------------------------------------------------------
    # cancellation and manual reconfiguration

    def cancel(self, job_id: int) -> str:
        """Remove a job from the system.

        Returns the disposition:

        * ``"unarrived"`` — the arrival was still pending; it will never
          enter the system (the queued ARRIVAL event is skipped on pop);
        * ``"dequeued"`` — the job was waiting unassigned; removed;
        * ``"preempted"`` — the job was running; it is preempted exactly like
          any other preemption (device and job preemption counters charged)
          and removed.  Energy/tardiness stop accruing from the current sim
          time: energy because the slice leaves the busy set, tardiness
          because the job leaves ``active``.

        Unknown, completed, or already-cancelled job ids raise
        :class:`ValueError` naming the sim time, the job id, and the remedy.
        """
        if self._awaiting is not None:
            raise RuntimeError(
                f"cannot cancel job {job_id} at t={self.sim.t}: an interactive "
                "decision is pending; call provide_decision() first"
            )
        sim = self.sim
        job = self._jobs_by_id.get(job_id)
        if job is None or job_id in self._cancelled_ids:
            state = "already cancelled" if job is not None else "never injected"
            raise ValueError(
                f"cannot cancel job {job_id} at sim time t={sim.t}: "
                f"it was {state}; check `status` for the job's disposition "
                f"before cancelling"
            )
        if job_id in sim.active:
            was_running = job_id in sim.assignment
            if was_running:
                # the existing preemption path: a running job leaving the
                # assignment counts once on the device and on the job
                del sim.assignment[job_id]
                sim.preemptions += 1
                job.preemptions += 1
            del sim.active[job_id]
            disposition = "preempted" if was_running else "dequeued"
        elif job.completion is not None:
            raise ValueError(
                f"cannot cancel job {job_id} at sim time t={sim.t}: it "
                f"already completed at t={job.completion}; completed jobs "
                f"cannot be cancelled"
            )
        else:
            # arrival event still pending in the heap: mark it so the pop
            # loop skips it without opening a decision point
            self._cancelled_pending.add(job_id)
            self.arrivals_pending -= 1
            disposition = "unarrived"
        self._cancelled_ids.add(job_id)
        sim.cancelled.append(job)
        if sim._repartitioning_until is None:
            sim._reschedule()
            sim._complete_finished()
        # version-bump: a live completion/critical prediction may reference
        # the cancelled job (or a seat freed by it)
        self._push_followups()
        return disposition

    def reconfigure(self, config_id: int) -> bool:
        """Start a repartition to ``config_id`` now (outside a decision point).

        The manual analogue of a policy decision: charges the same stall,
        follows the active ``repartition_mode``.  Returns False (no-op) when
        the device is already in that configuration.  Refuses while another
        repartition is in flight.
        """
        if self._awaiting is not None:
            raise RuntimeError(
                f"cannot reconfigure at t={self.sim.t}: an interactive "
                "decision is pending; call provide_decision() first"
            )
        sim = self.sim
        if sim._repartitioning_until is not None:
            raise RuntimeError(
                f"cannot reconfigure to {config_id} at sim time t={sim.t}: a "
                f"repartition to {sim._pending_config} is in flight until "
                f"t={sim._repartitioning_until}; retry after it completes"
            )
        if config_id == sim.partition.config_id:
            return False
        if config_id not in sim.configs:
            raise KeyError(
                f"cannot reconfigure to config {config_id}: not in this "
                f"device's table (valid ids {sorted(sim.configs)})"
            )
        sim._start_repartition(config_id)
        self._push(sim._repartitioning_until, EventKind.REPART_DONE)
        sim._reschedule()
        sim._complete_finished()
        self._push_followups()
        return True

    # ------------------------------------------------------------------
    # follow-up event scheduling (identical semantics to the old run() loop)

    def _push_followups(self) -> None:
        """Version-bump, then (re)schedule the earliest completion and the
        next critical-laxity crossing.  The bump invalidates every
        previously pushed completion/critical event, so only the newest
        prediction is ever acted on."""
        sim = self.sim
        self._version += 1
        if sim._repartitioning_until is not None:
            # mid-repartition: under partial mode jobs on surviving slices
            # keep running and may complete inside the 4 s window, so their
            # completion predictions must stay live.  No critical-laxity
            # follow-up: rescheduling is frozen until REPART_DONE (in drain
            # mode the assignment is empty and nothing is pushed — the
            # legacy event sequence, bit for bit).
            if sim.assignment:
                self._push_completion_followup()
            return
        self._push_completion_followup()
        crit = sim.scheduler.next_critical_time(
            sim.t, sim.partition, list(sim.active.values()), sim.assignment,
            sim.mig_enabled,
        )
        if crit is not None:
            self._push(crit, EventKind.CRITICAL, -1, self._version)

    def _push_completion_followup(self) -> None:
        """Push the earliest completion among running jobs (current version).

        Also the recovery path for a completion that fired early due to
        float accumulation: recomputing from current assignments converges
        to the true finish time instead of blindly re-pushing ``t + 1e-6``
        (which could burn the whole event budget on float-heavy workloads).
        """
        sim = self.sim
        best_t, best_id = math.inf, -1
        for jid, sl in sim.assignment.items():
            job = sim.active[jid]
            ft = job.finish_time_on(
                sim.t, sim.partition.slices[sl].slots, sim.mig_enabled
            )
            if ft < best_t:
                best_t, best_id = ft, jid
        if best_id >= 0 and math.isfinite(best_t):
            self._push(max(best_t, sim.t), EventKind.COMPLETION, best_id, self._version)

    def _schedule_policy_timer(self) -> None:
        # no more timers once the stream is closed, all arrivals are in,
        # and the queue is drained (a perpetual Day/Night boundary chain
        # would never terminate)
        if not self.stream_open and self.arrivals_pending == 0 and not self.sim.active:
            return
        if self.policy is None:
            return
        nt = self.policy.next_timer(self.sim.t)
        if nt is not None and nt > self.sim.t + _EPS and nt not in self._timer_scheduled:
            self._timer_scheduled.add(nt)
            self._push(nt, EventKind.TIMER)

    # ------------------------------------------------------------------
    # stepping

    @property
    def awaiting_decision(self) -> bool:
        """True when an interactive engine is paused at a decision point."""
        return self._awaiting is not None

    @property
    def awaiting_timer(self) -> bool:
        """True when the pending interactive decision point is a TIMER.

        Cadence-driven callers (``RepartitionEnv(decision_interval_min=...)``)
        use this to distinguish the policy-clock pauses they act on from the
        arrival/completion decision points they pass through.
        """
        return self._awaiting is not None and bool(self._awaiting[2])

    @property
    def finished(self) -> bool:
        """True when no events remain, none are pending, and none can come.

        A stream-open engine is never finished — it may merely be idle
        between injections; the producer must :meth:`close_stream` first.
        """
        return (
            not self._heap and self._awaiting is None and not self.stream_open
        )

    def next_event_time(self) -> Optional[float]:
        """Time of the earliest pending event (None when drained)."""
        return self._heap[0][0] if self._heap else None

    def step(self) -> Optional[EngineEvent]:
        """Process the next event; returns its record, or None when drained.

        In interactive mode the returned event has ``decision=True`` when
        the engine paused at a decision point — call
        :meth:`provide_decision` before stepping again.
        """
        return self._process_next(bound=None, inclusive=True)

    def run_until(self, t: float, *, inclusive: bool = True) -> int:
        """Process pending events up to ``t``; returns how many were run.

        ``inclusive=False`` stops *before* events at exactly ``t`` — the
        fleet dispatcher uses this to observe device state at ``t⁻``, the
        instant an arrival is about to be routed.  Stops early at a pending
        interactive decision.
        """
        n = 0
        while self._awaiting is None:
            if self._process_next(bound=t, inclusive=inclusive) is None:
                break
            n += 1
        return n

    def run_to_decision(self) -> bool:
        """Step until a decision point (True) or the queue drains (False)."""
        while self._awaiting is None:
            if self._process_next(bound=None, inclusive=True) is None:
                return False
        return True

    def drain(self) -> int:
        """Process every remaining event; returns how many were run."""
        n = 0
        while self._process_next(bound=None, inclusive=True) is not None:
            n += 1
        return n

    def _process_next(
        self, bound: Optional[float], inclusive: bool
    ) -> Optional[EngineEvent]:
        if self._awaiting is not None:
            raise RuntimeError(
                "decision pending at t="
                f"{self.sim.t}; call provide_decision() before stepping"
            )
        sim = self.sim
        while True:
            if not self._heap:
                return None
            t0 = self._heap[0][0]
            if bound is not None and (t0 > bound if inclusive else t0 >= bound):
                return None
            self.events_processed += 1
            if self.events_processed > sim.max_events:
                raise RuntimeError(
                    "event budget exceeded — likely a scheduling livelock"
                )
            ev_t, kind, _, payload, ver = heapq.heappop(self._heap)
            kind = EventKind(kind)
            if kind in (EventKind.COMPLETION, EventKind.CRITICAL) and ver != self._version:
                continue  # stale prediction, superseded by a later version
            if kind == EventKind.ARRIVAL and payload in self._cancelled_pending:
                # cancelled before arrival: the event is dead — skip it
                # without advancing time or opening a decision point
                self._cancelled_pending.discard(payload)
                continue
            break

        sim._advance(ev_t)
        if kind == EventKind.ARRIVAL:
            job = self._jobs_by_id[payload]
            sim.active[job.job_id] = job
            self.arrivals_pending -= 1
            return self._open_decision(kind, payload, timer=False)
        if kind == EventKind.COMPLETION:
            finished = sim._complete_finished()
            if not finished:
                # numerical race: the predicted finish undershot the float
                # depletion — recompute from current assignments rather
                # than re-pushing t + 1e-6 forever
                self._push_completion_followup()
                return self._emit(kind, payload, decision=False)
            return self._open_decision(kind, payload, timer=False)
        if kind == EventKind.CRITICAL:
            for job in sim.queue_snapshot():
                lax = sim.scheduler.job_laxity(sim.t, sim.partition, job, sim.mig_enabled)
                if (
                    lax <= sim.scheduler.critical_laxity_threshold + 1e-6
                    and job.critical_events < sim.scheduler.max_critical_preemptions
                ):
                    job.critical_events += 1
            sim._reschedule()
            sim._complete_finished()
            self._push_followups()
            return self._emit(kind, payload, decision=False)
        if kind == EventKind.REPART_DONE:
            sim._finish_repartition()
            sim._reschedule()
            sim._complete_finished()
            self._push_followups()
            return self._emit(kind, payload, decision=False)
        # TIMER
        self._timer_scheduled = {x for x in self._timer_scheduled if x > ev_t}
        return self._open_decision(kind, payload, timer=True)

    # ------------------------------------------------------------------
    # decision points

    def _open_decision(self, kind: EventKind, payload: int, timer: bool) -> EngineEvent:
        sim = self.sim
        if sim._repartitioning_until is not None:
            # the GPU is blocked mid-repartition: no decision point, but the
            # event still reschedules state exactly as the old loop did
            return self._finish_event(kind, payload, timer, decision=False)
        if self.decision_hook is not None:
            self.decision_hook(sim.t, sim)
        if self.interactive:
            self._awaiting = (kind, payload, timer)
            return self._emit(kind, payload, decision=True)
        choice = self.policy.decide(sim.t, sim) if self.policy is not None else None
        return self._apply_decision(kind, payload, timer, choice)

    def provide_decision(self, choice: Optional[int]) -> EngineEvent:
        """Supply the pending interactive decision and resume the event.

        ``choice`` is a config id to repartition to, or ``None`` to stay —
        the same contract as :meth:`RepartitionPolicy.decide`.
        """
        if self._awaiting is None:
            raise RuntimeError("no decision pending")
        kind, payload, timer = self._awaiting
        self._awaiting = None
        return self._apply_decision(kind, payload, timer, choice)

    def _apply_decision(
        self, kind: EventKind, payload: int, timer: bool, choice: Optional[int]
    ) -> EngineEvent:
        sim = self.sim
        if choice is not None and choice != sim.partition.config_id:
            if choice not in sim.configs:
                raise KeyError(
                    f"policy chose config {choice}, not in this device's "
                    f"table (valid ids {sorted(sim.configs)})"
                )
            sim._start_repartition(choice)
            self._push(sim._repartitioning_until, EventKind.REPART_DONE)
        return self._finish_event(kind, payload, timer, decision=True)

    def _finish_event(
        self, kind: EventKind, payload: int, timer: bool, decision: bool
    ) -> EngineEvent:
        sim = self.sim
        sim._reschedule()
        sim._complete_finished()
        if timer:
            self._schedule_policy_timer()
        self._push_followups()
        return self._emit(kind, payload, decision=decision)

    def _emit(self, kind: EventKind, payload: int, decision: bool) -> EngineEvent:
        sim = self.sim
        ev = EngineEvent(
            t=sim.t,
            kind=kind,
            job_id=payload,
            decision=decision,
            config_id=sim.partition.config_id,
            queue_depth=max(len(sim.active) - len(sim.assignment), 0),
        )
        if self.trace_sink is not None:
            self.trace_sink(ev)
        return ev

    # ------------------------------------------------------------------
    # state capture / restore (the service's checkpoints)

    def __getstate__(self) -> dict:
        """Pickle support: the whole engine state but the live callables.

        ``trace_sink`` and ``decision_hook`` are process-local observers,
        not simulation state: they are dropped and reattached after a
        restore.  Everything else (heap, versions, the ``itertools.count``
        sequence, the simulator's numbers, the policy's state) round-trips
        exactly, so a restored engine continues bit-identically.
        """
        state = self.__dict__.copy()
        state["trace_sink"] = None
        state["decision_hook"] = None
        return state

    def to_snapshot_bytes(self) -> bytes:
        """Serialize the engine (with its simulator and policy).

        Raises a clear error for a policy that does not pickle (a
        :class:`CallbackPolicy` over a closure): the service runs only
        registry policies, which all pickle.
        """
        import pickle

        try:
            return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:
            raise ValueError(
                f"engine state is not picklable ({e}); checkpointing "
                "requires a picklable policy/scheduler — CallbackPolicy "
                "closures are not; use a registry policy "
                "(repro_torch.service.make_policy)"
            ) from e

    @classmethod
    def from_snapshot_bytes(
        cls,
        blob: bytes,
        *,
        trace_sink: Optional[TraceSink] = None,
        decision_hook: Optional[Callable[[float, "MIGSimulator"], None]] = None,
    ) -> "SimulationEngine":
        """Restore an engine from :meth:`to_snapshot_bytes` output.

        The restored engine resumes mid-run, bit-identically.  Observers are
        not part of the snapshot; pass them here to reattach them.
        """
        import pickle

        engine = pickle.loads(blob)
        if not isinstance(engine, cls):
            raise ValueError(
                f"snapshot blob holds a {type(engine).__name__}, "
                f"not a {cls.__name__}"
            )
        engine.trace_sink = trace_sink
        engine.decision_hook = decision_hook
        return engine

    def harvest_completed(self) -> Tuple[List[Job], List[Job]]:
        """Remove and return the (completed, cancelled) jobs so far.

        A long-running service folds them into running aggregates
        (:class:`repro_torch.service.ServiceStats`), so its memory stays
        bounded over multi-day streams; the engine's own :meth:`result`
        refuses once any job was folded out (it would under-count).
        """
        sim = self.sim
        done, cancelled = sim.completed, sim.cancelled
        sim.completed, sim.cancelled = [], []
        for job in done:
            del self._jobs_by_id[job.job_id]
        for job in cancelled:
            del self._jobs_by_id[job.job_id]
            self._cancelled_ids.discard(job.job_id)
        self._harvested += len(done) + len(cancelled)
        return done, cancelled

    # ------------------------------------------------------------------
    # observation / results

    def job_disposition(self, job_id: int) -> Optional[str]:
        """Where a job currently is, or None if unknown (or harvested).

        One of ``"pending"`` (arrival event still queued), ``"queued"``
        (arrived, unassigned), ``"running"``, ``"completed"``, or
        ``"cancelled"``; the service's ``status`` op reads this.
        """
        job = self._jobs_by_id.get(job_id)
        if job is None:
            return None
        if job_id in self._cancelled_ids:
            return "cancelled"
        if job_id in self.sim.assignment:
            return "running"
        if job_id in self.sim.active:
            return "queued"
        if job.completion is not None:
            return "completed"
        return "pending"

    def snapshot(self) -> EngineSnapshot:
        """Read-only view of device + queue state (see :class:`EngineSnapshot`)."""
        return EngineSnapshot(
            sim=self.sim.snapshot(),
            next_event_time=self.next_event_time(),
            pending_arrivals=self.arrivals_pending,
            events_processed=self.events_processed,
            stream_open=self.stream_open,
            awaiting_decision=self.awaiting_decision,
        )

    def result(self) -> SimResult:
        """The run's :class:`SimResult`; only valid once :attr:`finished`."""
        if not self.finished:
            raise RuntimeError(
                "simulation still has pending events (or an open stream); "
                "close_stream() and drain() it first"
            )
        if self._harvested:
            raise RuntimeError(
                f"{self._harvested} jobs were folded out by "
                "harvest_completed(); the harvester owns the final result "
                "(repro_torch.service.ServiceStats.result)"
            )
        sim = self.sim
        if sim.active:
            raise RuntimeError(
                f"simulation ended with {len(sim.active)} unfinished jobs"
            )
        m = max(len(sim.completed), 1)
        total_tard = sum(j.tardiness() for j in sim.completed)
        tenant_acc: Dict[str, List[float]] = {}
        for j in sim.completed:
            if j.tenant is None:
                continue
            acc = tenant_acc.setdefault(j.tenant, [0, 0, 0.0])
            acc[0] += 1
            acc[1] += 1 if j.slo_attained() else 0
            acc[2] += j.latency()
        tenants = {
            name: TenantSLOStats(
                jobs=int(acc[0]), attained=int(acc[1]), latency_sum_min=acc[2]
            )
            for name, acc in sorted(tenant_acc.items())
        }
        extra = {
            "makespan_min": sim.t,
            "tardiness_integral": sim.tardiness_integral,
        }
        # only runs with cancellations report them: batch results keep the
        # reference's key set (the key is absent, not zero)
        if sim.cancelled:
            extra["cancelled_jobs"] = float(len(sim.cancelled))
        return SimResult(
            energy_wh=sim.energy_wh,
            avg_tardiness=total_tard / m,
            num_jobs=len(sim.completed),
            total_tardiness=total_tard,
            preemptions=sim.preemptions,
            repartitions=sim.repartitions,
            max_tardiness=max((j.tardiness() for j in sim.completed), default=0.0),
            deadline_misses=sum(1 for j in sim.completed if j.tardiness() > 1e-9),
            busy_slot_minutes=sim.busy_slot_minutes,
            extra=extra,
            tenants=tenants,
        )


def snapshot_of(sim: "MIGSimulator") -> SimSnapshot:
    """Build the :class:`SimSnapshot` for a simulator's current state."""
    n_inf = n_trn = 0
    w_inf = w_trn = 0.0
    for j in sim.active.values():
        if j.done:
            continue
        if j.kind == JobKind.TRAINING:
            n_trn += 1
            w_trn += j.remaining
        else:
            n_inf += 1
            w_inf += j.remaining
    service_rate = sum(
        sim.active[jid].rate_on(sim.partition.slices[sl].slots, sim.mig_enabled)
        for jid, sl in sim.assignment.items()
    )
    repart_until = sim._repartitioning_until
    occupied = tuple(sorted(set(sim.assignment.values())))
    geometry = free_slot_geometry(
        sim.partition,
        occupied,
        total_slots=sim.grid_slots,
        slice_sizes=sim.slice_sizes,
    )
    return SimSnapshot(
        t=sim.t,
        config_id=sim.partition.config_id,
        num_slices=sim.partition.num_slices,
        mig_enabled=sim.mig_enabled,
        repartitioning=repart_until is not None,
        repartition_remaining_min=(
            max(repart_until - sim.t, 0.0) if repart_until is not None else 0.0
        ),
        stalled_slots=sim.stalled_slots,
        occupied_slices=occupied,
        jobs_in_system=n_inf + n_trn,
        active_jobs=len(sim.active),
        queue_depth=max(len(sim.active) - len(sim.assignment), 0),
        running=len(sim.assignment),
        completed_jobs=len(sim.completed),
        busy_slots=sim.busy_slots,
        backlog_1g_min=w_inf + w_trn,
        service_rate_1g_per_min=service_rate,
        inference_jobs=n_inf,
        inference_backlog_1g_min=w_inf,
        training_jobs=n_trn,
        training_backlog_1g_min=w_trn,
        energy_wh=sim.energy_wh,
        tardiness_integral=sim.tardiness_integral,
        preemptions=sim.preemptions,
        repartitions=sim.repartitions,
        free_slots=geometry.free_slots,
        max_placeable_slots=geometry.max_placeable_slots,
        fragmentation=geometry.fragmentation,
    )
