"""Fleet-level MIG simulation: N heterogeneous GPUs behind one dispatcher.

Execution model — **online** (the default, ``dispatch_info="online"``):
every device gets its own steppable :class:`~repro_torch.core.engine.SimulationEngine`
and the fleet co-advances them on a merged event clock.  At each arrival
every engine is run up to (but not through) the arrival instant, the
pluggable dispatcher (:mod:`repro_torch.fleet.dispatch`) observes **real** device
state — actual outstanding work, queue depth, the current partition, any
in-flight repartition — through live engine snapshots, and the job is
injected into the chosen device's engine.  When the stream ends the engines
drain independently.

The legacy **fluid** mode (``dispatch_info="fluid"``) is the two-phase
pre-split this replaced: the arrival stream is walked once against a fluid
per-device backlog estimate, then each device simulates its subset from
scratch.  It is kept as an explicit mode so the online-vs-fluid gap stays a
measurable number (the ``dispatchers`` sweep grid / EXPERIMENTS.md).

Per-device :class:`~repro_torch.core.metrics.SimResult`\\ s are then aggregated
into fleet totals.  The load-bearing invariant — pinned by tests and the
``fleet_scaling`` baseline — is that a **1-device fleet is bit-identical
to the single-MIG path** in *both* modes: one device receives the job list
unchanged (event-for-event, whichever mode delivers it), and
``aggregate_sim_results`` of one result *is* that result.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.engine import SimulationEngine
from repro_torch.core.jobs import Job
from repro_torch.core.metrics import SimResult, merge_tenant_stats
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import MIGSimulator, RepartitionPolicy
from repro_torch.core.slices import MIG_CONFIGS, Partition
from repro_torch.fleet.devices import DeviceProfile, device_profile
from repro_torch.fleet.dispatch import (
    DispatchTrace,
    DispatchContext,
    EngineDeviceState,
    as_context_dispatcher,
    dispatch_jobs,
    make_dispatcher,
)

__all__ = [
    "DeviceAdaptedPolicy",
    "FleetDeviceSpec",
    "FleetSpec",
    "FleetResult",
    "FleetStream",
    "FleetView",
    "FleetSimulator",
    "aggregate_sim_results",
]

#: valid ``FleetSpec.dispatch_info`` values
DISPATCH_INFO_MODES = ("online", "fluid")


@dataclasses.dataclass(frozen=True)
class FleetDeviceSpec:
    """One fleet member: a profile name plus optional per-device overrides."""

    profile: str
    scheduler: Optional[str] = None  # None -> the fleet default
    initial_config: Optional[int] = None  # None -> the policy's choice


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A fleet: device list, dispatcher, in-device scheduler, dispatch mode.

    ``dispatch_info`` selects what the dispatcher observes: ``"online"``
    (default) co-advances per-device engines and exposes real state;
    ``"fluid"`` is the legacy backlog-estimate pre-split.  The toggle is
    *deprecated as an API surface*: dispatchers no longer see it — both
    modes hand them the same :class:`~repro_torch.fleet.dispatch.DispatchContext`
    (with ``ctx.online`` set accordingly) — and it survives only so that
    existing sweep cells, which encode it under the ``fleet.info`` key,
    keep hashing byte-identically.
    ``repartition_mode`` is applied to every device simulator — ``"partial"``
    (slot-placed transitions, the default) or ``"drain"`` (legacy full
    drain); see :class:`repro_torch.core.simulator.MIGSimulator`.
    """

    devices: Tuple[FleetDeviceSpec, ...]
    dispatcher: str = "round-robin"
    scheduler: str = "EDF-SS"
    dispatch_info: str = "online"
    repartition_mode: str = "partial"

    @staticmethod
    def of(profiles: Sequence[str], dispatcher: str = "round-robin",
           scheduler: str = "EDF-SS", dispatch_info: str = "online",
           repartition_mode: str = "partial") -> "FleetSpec":
        """Shorthand: a fleet from profile names with no per-device overrides."""
        return FleetSpec(
            devices=tuple(FleetDeviceSpec(profile=p) for p in profiles),
            dispatcher=dispatcher,
            scheduler=scheduler,
            dispatch_info=dispatch_info,
            repartition_mode=repartition_mode,
        )


@dataclasses.dataclass
class FleetResult:
    """Aggregate + per-device outcome of one fleet run."""

    aggregate: SimResult
    per_device: List[SimResult]
    dispatch_counts: List[int]
    trace: DispatchTrace

    @property
    def num_devices(self) -> int:
        """Fleet size of the run that produced this result."""
        return len(self.per_device)


class FleetView:
    """Read-only fleet-load lookup for fleet-aware observations.

    Wraps the dispatch-time trace (one per-device backlog record per routed
    job — *real* backlogs in online mode, fluid estimates in fluid mode):
    ``load_share(i, t)`` is device ``i``'s share of the fleet backlog at the
    last routing decision before ``t``, ``total_load_norm(t)`` the fleet
    backlog normalized to ``norm_min`` device-minutes and clipped to [0, 1].

    In online mode the view also holds the live engines: *while the
    arrival stream is open* (the engines are being co-advanced together), a
    lookup at or past the newest trace record reads the engines' current
    snapshots instead of the last record — mid-run observers (per-device RL
    features, streaming telemetry) see the device state as it is now, not
    as it was at the previous arrival.  Once the stream closes the engines
    drain independently (their clocks diverge), so lookups fall back to the
    recorded trace — the same post-run behavior as fluid mode.
    """

    def __init__(self, trace: DispatchTrace, profiles: Sequence[DeviceProfile],
                 norm_min: float = 120.0,
                 engines: Optional[Sequence[SimulationEngine]] = None) -> None:
        # the trace list is shared with the running FleetSimulator in online
        # mode (append-only); index lazily so mid-run reads see fresh records
        self._trace = trace
        self._profiles = list(profiles)
        self._norm_min = norm_min
        self._engines = list(engines) if engines is not None else None

    def _at(self, t: float) -> Optional[Tuple[float, ...]]:
        if (
            self._engines is not None
            and all(e.stream_open for e in self._engines)
            and (not self._trace or t >= self._trace[-1][0])
        ):
            return tuple(
                e.sim.snapshot().backlog_1g_min for e in self._engines
            )
        i = bisect.bisect_right(self._trace, t, key=lambda rec: rec[0]) - 1
        return self._trace[i][1] if i >= 0 else None

    def load_share(self, device_index: int, t: float) -> float:
        """Device's fraction of the fleet backlog just before ``t``."""
        rec = self._at(t)
        if rec is None:
            return 0.0
        total = sum(rec)
        return rec[device_index] / total if total > 0.0 else 0.0

    def total_load_norm(self, t: float) -> float:
        """Fleet backlog in device-minutes, normalized+clipped to [0, 1]."""
        rec = self._at(t)
        if rec is None:
            return 0.0
        device_minutes = sum(
            b / p.total_slots for b, p in zip(rec, self._profiles, strict=True)
        )
        return min(device_minutes / self._norm_min, 1.0)


def aggregate_sim_results(per_device: Sequence[SimResult]) -> SimResult:
    """Fleet totals from per-device results.

    For one device the input is returned unchanged — this is what makes the
    1-GPU fleet bit-identical to the single-MIG path by construction rather
    than by floating-point luck.
    """
    if not per_device:
        raise ValueError("no device results")
    if len(per_device) == 1:
        return per_device[0]
    num_jobs = sum(r.num_jobs for r in per_device)
    total_tard = sum(r.total_tardiness for r in per_device)
    return SimResult(
        energy_wh=sum(r.energy_wh for r in per_device),
        avg_tardiness=total_tard / max(num_jobs, 1),
        num_jobs=num_jobs,
        total_tardiness=total_tard,
        preemptions=sum(r.preemptions for r in per_device),
        repartitions=sum(r.repartitions for r in per_device),
        max_tardiness=max(r.max_tardiness for r in per_device),
        deadline_misses=sum(r.deadline_misses for r in per_device),
        busy_slot_minutes=sum(r.busy_slot_minutes for r in per_device),
        extra={
            "makespan_min": max(r.extra.get("makespan_min", 0.0) for r in per_device),
            "tardiness_integral": sum(
                r.extra.get("tardiness_integral", 0.0) for r in per_device
            ),
        },
        tenants=merge_tenant_stats(r.tenants for r in per_device),
    )


class DeviceAdaptedPolicy:
    """Maps a policy's config choices onto a non-A100 device's table.

    Every registered dynamic policy (daynight, heuristic, DQN) emits ids in
    the paper's A100 Fig. 1 space; on a device with a different table those
    ids would KeyError mid-run.  An out-of-table choice is mapped to the
    device config whose *slice count* is closest to the requested A100
    layout's — the policy decides how finely partitioned the GPU should be,
    and that intent survives the translation.  In-table choices pass through
    untouched, so the wrapper is the identity on A100 devices.
    """

    def __init__(self, inner: RepartitionPolicy, configs: "dict[int, Partition]") -> None:
        self.inner = inner
        self.configs = dict(configs)
        self.initial_config = self._map(inner.initial_config)

    def _map(self, choice: Optional[int]) -> Optional[int]:
        if choice is None or choice in self.configs:
            return choice
        ref = MIG_CONFIGS.get(choice)
        if ref is None:
            return choice  # unknown everywhere: let the simulator raise
        want = ref.num_slices
        return min(
            self.configs,
            key=lambda cid: (abs(self.configs[cid].num_slices - want), cid),
        )

    def decide(self, t: float, sim: MIGSimulator) -> Optional[int]:
        """Inner policy's choice, translated onto this device's table."""
        return self._map(self.inner.decide(t, sim))

    def next_timer(self, t: float) -> Optional[float]:
        """Pass through the inner policy's timer chain unchanged."""
        return self.inner.next_timer(t)


#: per-device policy source: ``factory(device_index, profile) -> policy``
PolicyFactory = Callable[[int, DeviceProfile], RepartitionPolicy]


class FleetSimulator:
    """Run a :class:`FleetSpec` over a job stream.

    Policies are built per device via ``policy_factory`` (policy instances
    carry per-run state and must never be shared across devices).  The last
    run's per-device simulators stay on ``self.sims`` (and, in online mode,
    their engines on ``self.engines``) for inspection — the RL layer reads
    their state through :func:`repro_torch.core.rl.env.fleet_state_features`.
    """

    def __init__(self, spec: FleetSpec, mig_enabled: bool = True) -> None:
        if not spec.devices:
            raise ValueError("fleet needs at least one device")
        if spec.dispatch_info not in DISPATCH_INFO_MODES:
            raise ValueError(
                f"unknown dispatch_info {spec.dispatch_info!r}; "
                f"valid: {DISPATCH_INFO_MODES}"
            )
        self.spec = spec
        self.mig_enabled = mig_enabled
        self.profiles = [device_profile(d.profile) for d in spec.devices]
        self.sims: List[MIGSimulator] = []
        self.engines: List[SimulationEngine] = []
        self.view: Optional[FleetView] = None

    def _device_policy(self, i: int, prof: DeviceProfile,
                       policy_factory: PolicyFactory) -> RepartitionPolicy:
        policy = policy_factory(i, prof)
        if set(prof.configs) != set(MIG_CONFIGS):
            # non-A100 table: translate the policy's A100-space choices
            policy = DeviceAdaptedPolicy(policy, prof.configs)
        return policy

    def run(
        self,
        jobs: Sequence[Job],
        policy_factory: PolicyFactory,
    ) -> FleetResult:
        """Dispatch ``jobs`` across the fleet and simulate every device.

        Returns the aggregated :class:`FleetResult`; per-device simulators
        stay on ``self.sims`` for inspection.
        """
        if self.spec.dispatch_info == "fluid":
            return self._run_fluid(jobs, policy_factory)
        return self._run_online(jobs, policy_factory)

    # ------------------------------------------------------------------
    def open_stream(self, policy_factory: PolicyFactory) -> "FleetStream":
        """Open an incremental submission stream over this fleet.

        The streaming core of online mode, exposed: the scheduler service
        (:mod:`repro_torch.service`) submits, cancels, and co-advances
        through the returned :class:`FleetStream` one operation at a time,
        while
        :meth:`run` remains the batch wrapper that feeds a whole job list
        through the same code path (bit-identical by construction).
        """
        stream = FleetStream(self, policy_factory)
        self.engines = stream.engines
        self.sims = [e.sim for e in stream.engines]
        self.view = stream.view
        return stream

    def _run_online(self, jobs: Sequence[Job], policy_factory: PolicyFactory) -> FleetResult:
        """Co-advance one engine per device on the merged arrival clock."""
        stream = self.open_stream(policy_factory)
        for job in jobs:
            stream.submit(job)
        stream.close()
        return stream.result()

    # ------------------------------------------------------------------
    def _run_fluid(self, jobs: Sequence[Job], policy_factory: PolicyFactory) -> FleetResult:
        """Legacy two-phase pre-split over the fluid backlog estimate.

        ``dispatch_jobs`` rejects dispatchers that require real engine
        state (``state-aware``) with a clear error.
        """
        dispatcher = make_dispatcher(self.spec.dispatcher)
        assignments, trace = dispatch_jobs(jobs, self.profiles, dispatcher)
        self.view = FleetView(trace, self.profiles)

        self.sims = []
        self.engines = []
        per_device: List[SimResult] = []
        counts = [0] * len(self.profiles)
        for a in assignments:
            counts[a] += 1
        for i, (dev, prof) in enumerate(zip(self.spec.devices, self.profiles, strict=True)):
            subset = [job for job, a in zip(jobs, assignments, strict=True) if a == i]
            sim = MIGSimulator(
                make_scheduler(dev.scheduler or self.spec.scheduler),
                power_model=prof.power,
                mig_enabled=self.mig_enabled,
                config_table=prof.configs,
                repartition_mode=self.spec.repartition_mode,
            )
            res = sim.run(
                subset,
                policy=self._device_policy(i, prof, policy_factory),
                initial_config=dev.initial_config,
            )
            self.sims.append(sim)
            per_device.append(res)
        return self._finish(per_device, counts, trace)

    # ------------------------------------------------------------------
    def _finish(
        self, per_device: List[SimResult], counts: List[int], trace: DispatchTrace
    ) -> FleetResult:
        return _finish_result(self.profiles, per_device, counts, trace)


def _finish_result(
    profiles: Sequence[DeviceProfile],
    per_device: List[SimResult],
    counts: List[int],
    trace: DispatchTrace,
) -> FleetResult:
    aggregate = aggregate_sim_results(per_device)
    if len(per_device) > 1:
        # Per-device energy only covers [0, device makespan] (the single-GPU
        # convention).  Devices the dispatcher starved still draw idle power
        # until the fleet drains; report that separately so packing
        # dispatchers aren't credited with turning idle silicon off.
        fleet_makespan = aggregate.extra["makespan_min"]
        idle_gap_wh = sum(
            prof.power.idle_watts
            * max(fleet_makespan - res.extra.get("makespan_min", 0.0), 0.0)
            / 60.0
            for prof, res in zip(profiles, per_device, strict=True)
        )
        aggregate = dataclasses.replace(
            aggregate,
            extra={**aggregate.extra, "fleet_idle_gap_wh": idle_gap_wh},
        )
    return FleetResult(
        aggregate=aggregate,
        per_device=per_device,
        dispatch_counts=counts,
        trace=trace,
    )


class FleetStream:
    """Incremental online-dispatch session over a fleet (one op at a time).

    Built by :meth:`FleetSimulator.open_stream`.  Owns one stream-open
    :class:`~repro_torch.core.engine.SimulationEngine` per device plus the
    dispatcher and the dispatch trace; :meth:`submit` performs exactly one
    iteration of the batch loop (co-advance to the arrival, observe, pick,
    inject), so a stream fed a whole sorted job list then closed is
    bit-identical to :meth:`FleetSimulator.run`.  The additions over the
    batch path:

    * :meth:`cancel` routes a cancellation to the engine that owns the job
      (the stream remembers every routing decision);
    * :meth:`run_until` co-advances all engines to a bound with no arrival
      (the service's idle tick);
    * the whole object pickles (engines, dispatcher state, owner map, trace)
      for the service's checkpoints, as a single engine does.
    """

    def __init__(self, fleet: FleetSimulator, policy_factory: PolicyFactory) -> None:
        spec = fleet.spec
        self.dispatcher = as_context_dispatcher(make_dispatcher(spec.dispatcher))
        self.profiles = fleet.profiles
        engines: List[SimulationEngine] = []
        for i, (dev, prof) in enumerate(zip(spec.devices, fleet.profiles, strict=True)):
            sim = MIGSimulator(
                make_scheduler(dev.scheduler or spec.scheduler),
                power_model=prof.power,
                mig_enabled=fleet.mig_enabled,
                config_table=prof.configs,
                repartition_mode=spec.repartition_mode,
            )
            engines.append(
                SimulationEngine(
                    sim,
                    policy=fleet._device_policy(i, prof, policy_factory),
                    initial_config=dev.initial_config,
                    stream_open=True,
                )
            )
        self.engines = engines
        self.states = [
            EngineDeviceState(i, prof, engine)
            for i, (prof, engine) in enumerate(zip(fleet.profiles, engines, strict=True))
        ]
        self.trace: DispatchTrace = []
        self.view = FleetView(self.trace, fleet.profiles, engines=engines)
        self.counts = [0] * len(engines)
        self.owner: "dict[int, int]" = {}  # job_id -> device index
        self.closed = False
        self._prev_arrival = 0.0

    def submit(self, job: Job) -> int:
        """Dispatch one arrival; returns the chosen device index."""
        if self.closed:
            raise RuntimeError(
                f"cannot submit job {job.job_id}: the fleet stream is closed"
            )
        if job.arrival < self._prev_arrival - 1e-9:
            raise ValueError("fleet dispatch requires arrival-sorted jobs")
        self._prev_arrival = job.arrival
        # advance every device past all events before the arrival, then
        # project each view to the arrival instant itself (a device's
        # clock rests at its last event; between events state evolves
        # linearly, so the projection is exact) — the dispatcher
        # compares every device at the same simulated time t⁻
        for engine, st in zip(self.engines, self.states, strict=True):
            engine.run_until(job.arrival, inclusive=False)
            st.observe_at(job.arrival)
        ctx = DispatchContext(
            t=job.arrival, job=job, devices=self.states, online=True
        )
        i = self.dispatcher.pick(ctx)
        if not (0 <= i < len(self.states)):
            raise IndexError(f"dispatcher {self.dispatcher.name} picked device {i}")
        self.engines[i].inject(job)
        self.counts[i] += 1
        self.states[i].dispatched += 1
        self.owner[job.job_id] = i
        # record the post-decision backlog: the injected arrival is not
        # processed yet, so the routed job's work is added explicitly —
        # same "backlog after each routing decision" contract as the
        # fluid trace
        self.trace.append(
            (
                job.arrival,
                tuple(
                    st.backlog_1g_min + (job.work if k == i else 0.0)
                    for k, st in enumerate(self.states)
                ),
            )
        )
        return i

    def cancel(self, job_id: int) -> str:
        """Cancel a previously submitted job on whichever device owns it."""
        i = self.owner.get(job_id)
        if i is None:
            raise ValueError(
                f"cannot cancel job {job_id}: it was never dispatched on "
                f"this fleet stream; check `status` for its disposition"
            )
        return self.engines[i].cancel(job_id)

    def run_until(self, t: float) -> int:
        """Co-advance every engine up to (not through) ``t``; total events.

        The same exclusive bound as the pre-arrival co-advance, so a tick at
        ``t`` followed by a submit at ``t`` is indistinguishable from the
        submit alone — ticks never perturb replay determinism.
        """
        self._prev_arrival = max(self._prev_arrival, t)
        return sum(e.run_until(t, inclusive=False) for e in self.engines)

    def close(self) -> None:
        """End the stream and drain every device to completion."""
        for engine in self.engines:
            engine.close_stream()
        for engine in self.engines:
            engine.drain()
        self.closed = True

    def result(self) -> FleetResult:
        """Aggregate results; only valid after :meth:`close`."""
        if not self.closed:
            raise RuntimeError("fleet stream still open; close() it first")
        per_device = [engine.result() for engine in self.engines]
        return _finish_result(self.profiles, per_device, self.counts, self.trace)
