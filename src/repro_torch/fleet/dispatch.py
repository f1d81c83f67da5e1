"""Fleet dispatchers: route arriving jobs to MIG-capable devices.

The default fleet execution is *online* (see :mod:`repro_torch.fleet.simulator`):
per-device simulation engines are co-advanced to each arrival on a merged
event clock, and the dispatcher observes **real** device state — actual
outstanding work, queue depth, the current partition, and any in-flight
repartition — through :class:`EngineDeviceState` views over live engine
snapshots.  The legacy *fluid* mode (``dispatch_info="fluid"``) instead
walks the arrival stream once against a cheap backlog estimate that drains
at the device's peak slot count — the first-order model the MIG cluster
schedulers use for placement scoring (Tan et al.; Zambianco et al.).  The
``dispatchers`` sweep grid measures the online-vs-fluid gap.

Every dispatcher consumes one typed argument, a :class:`DispatchContext`:
the arriving job, the arrival instant, and a device-state view per fleet
member.  Both execution modes build the same context type — the fluid mode
fills it with :class:`DeviceLoadState` estimates, the online mode with
:class:`EngineDeviceState` engine views — so a dispatcher is written once
against :class:`DeviceState` and the context says (``ctx.online``) which
fidelity it is getting.  The pre-context call shape ``pick(job, t,
states)`` is still accepted through a deprecation shim
(:func:`as_context_dispatcher`), so external dispatchers keep working and
existing sweep cells hash identically.

Dispatchers (all deterministic):

* ``round-robin``         — arrival index modulo fleet size (the baseline);
* ``least-loaded``        — smallest normalized backlog (backlog / peak slots);
* ``energy-greedy``       — smallest *marginal power* for one more busy slot
  at the device's estimated utilization: exploits the concave Fig. 3 curve
  by packing onto already-hot devices and preferring low-power devices when
  everything is idle;
* ``state-aware``         — online-only: minimizes an expected-start-delay
  proxy built from real state (normalized backlog + remaining repartition
  stall + a congestion step when no slice is free), breaking ties toward
  the cheaper marginal watt;
* ``fragmentation-aware`` — online-only: the state-aware delay proxy plus a
  slice-fit term (can the device place the request's slice class right
  now?) and a post-placement fragmentation penalty over the free-slot
  geometry (DESIGN.md §9) — the 2512.16099-style serving dispatcher.
"""

from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

from repro_torch.core.jobs import Job
from repro_torch.core.slices import FreeSlotGeometry, free_slot_geometry
from repro_torch.fleet.devices import DeviceProfile

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.engine import SimulationEngine

__all__ = [
    "DeviceState",
    "DeviceLoadState",
    "EngineDeviceState",
    "DispatchContext",
    "Dispatcher",
    "StateAwareDispatcher",
    "FragmentationAwareDispatcher",
    "DISPATCHERS",
    "make_dispatcher",
    "as_context_dispatcher",
    "dispatch_jobs",
    "DispatchTrace",
]

# horizon over which an estimated backlog is smeared into busy slots for the
# energy-greedy marginal-power estimate (minutes)
_ENERGY_LOOKAHEAD_MIN = 30.0


def job_demand_slots(job: Job) -> int:
    """Slice width a job "wants": its elasticity cap, else 1 slot.

    Capped jobs gain nothing beyond their cap, so the cap is the natural
    slice class to place them on (serving tenants are generated this way —
    the tenant's model footprint maps to a capped elasticity).  Linear and
    sublinear jobs accept any slice, so their placement demand is the
    minimal 1 slot.
    """
    cap = getattr(job.elasticity, "cap", None)
    return int(cap) if cap else 1


@runtime_checkable
class DeviceState(Protocol):
    """What a dispatcher may observe about one fleet device.

    Both state views implement this surface.  The fluid
    :class:`DeviceLoadState` answers the real-state members with
    conservative defaults (no queue, no repartition, no geometry) — the
    honest encoding of "the fluid model cannot see this"; dispatchers that
    *require* real answers declare ``requires_online`` and are rejected in
    fluid mode before they can be misled.
    """

    index: int
    profile: DeviceProfile
    dispatched: int

    @property
    def backlog_1g_min(self) -> float: ...

    @property
    def normalized_load(self) -> float: ...

    def est_busy_slots(self) -> float: ...

    @property
    def queue_depth(self) -> int: ...

    @property
    def repartition_remaining_min(self) -> float: ...

    @property
    def stalled_fraction(self) -> float: ...

    @property
    def free_slices(self) -> int: ...

    def free_geometry(self) -> Optional[FreeSlotGeometry]: ...


@dataclasses.dataclass
class DeviceLoadState:
    """Dispatcher-visible fluid estimate of one device's outstanding work."""

    index: int
    profile: DeviceProfile
    backlog_1g_min: float = 0.0  # outstanding work, 1g-slice-minutes
    last_t: float = 0.0
    dispatched: int = 0

    def drain_to(self, t: float) -> None:
        """Advance the fluid model: backlog drains at peak slot rate."""
        dt = max(t - self.last_t, 0.0)
        self.backlog_1g_min = max(
            self.backlog_1g_min - dt * self.profile.total_slots, 0.0
        )
        self.last_t = max(self.last_t, t)

    @property
    def normalized_load(self) -> float:
        """Backlog in device-minutes (backlog over peak drain rate)."""
        return self.backlog_1g_min / self.profile.total_slots

    def est_busy_slots(self) -> float:
        """Backlog smeared over the lookahead window, capped at the device."""
        slots = self.backlog_1g_min / _ENERGY_LOOKAHEAD_MIN
        return min(slots, float(self.profile.total_slots))

    # -- real-state surface: the fluid model cannot see any of it --------
    @property
    def queue_depth(self) -> int:
        return 0

    @property
    def repartition_remaining_min(self) -> float:
        return 0.0

    @property
    def stalled_slots(self) -> int:
        return 0

    @property
    def stalled_fraction(self) -> float:
        return 0.0

    @property
    def free_slices(self) -> int:
        return self.profile.configs[self.profile.default_config].num_slices

    def free_geometry(self) -> Optional[FreeSlotGeometry]:
        return None


class EngineDeviceState:
    """Live, real-state view of one device for online dispatch.

    Exposes the same :class:`DeviceState` surface the fluid
    :class:`DeviceLoadState` offers, so every dispatcher runs unmodified in
    both modes — but here the numbers are read off the device's live engine
    snapshot: the backlog is the *actual* outstanding work of jobs in the
    system, and the online-only signals (queue depth, in-flight
    repartition, free slices and free-slot geometry on the current
    partition) exist only on this view.

    A device's simulator clock sits at its *last processed event*, which
    may lag the arrival being routed by a different amount per device.
    :meth:`observe_at` sets the observation instant: between events the
    backlog drains linearly at the snapshot's ``service_rate_1g_per_min``
    (and a repartition stall shrinks at unit rate), so the view projects
    both to exactly ``t`` — every device is compared at the same simulated
    time without touching the simulation itself.  Job membership (queue
    depth, free slices) cannot change between events, so those need no
    projection.
    """

    def __init__(self, index: int, profile: DeviceProfile, engine: "SimulationEngine") -> None:
        self.index = index
        self.profile = profile
        self.engine = engine
        self.dispatched = 0
        self._t_obs: "float | None" = None
        self._cache_stamp = -1
        self._cache_snap = None

    def observe_at(self, t: float) -> None:
        """Project subsequent reads to the instant ``t`` (>= the device clock)."""
        self._t_obs = t

    @property
    def _snap(self):
        # one snapshot per engine advance: the sim state only changes when
        # events process, so a pick() reading several properties — and the
        # trace record right after — reuse a single O(active) scan
        stamp = self.engine.events_processed
        if self._cache_snap is None or stamp != self._cache_stamp:
            self._cache_snap = self.engine.sim.snapshot()
            self._cache_stamp = stamp
        return self._cache_snap

    @property
    def _gap_min(self) -> float:
        """Minutes between the device clock and the observation instant."""
        if self._t_obs is None:
            return 0.0
        return max(self._t_obs - self._snap.t, 0.0)

    @property
    def backlog_1g_min(self) -> float:
        """Outstanding work (1g-minutes), projected to the observed instant."""
        snap = self._snap
        return max(
            snap.backlog_1g_min - snap.service_rate_1g_per_min * self._gap_min,
            0.0,
        )

    @property
    def normalized_load(self) -> float:
        """Backlog in device-minutes (backlog over peak drain rate)."""
        return self.backlog_1g_min / self.profile.total_slots

    def est_busy_slots(self) -> float:
        """Backlog smeared over the lookahead window, capped at the device."""
        return min(
            self.backlog_1g_min / _ENERGY_LOOKAHEAD_MIN,
            float(self.profile.total_slots),
        )

    # -- online-only signals (what the fluid estimate cannot see) --------
    @property
    def queue_depth(self) -> int:
        """Jobs waiting (in system, not running) at the observed instant."""
        return self._snap.queue_depth

    @property
    def repartition_remaining_min(self) -> float:
        """Minutes of repartition stall left at the observed instant (0 if none)."""
        return max(self._snap.repartition_remaining_min - self._gap_min, 0.0)

    @property
    def stalled_slots(self) -> int:
        """Slot footprint of the in-flight repartition (0 when idle).

        Under partial repartitioning only the rebuilt slice instances
        stall — a device mid-reconfiguration with most of its slots
        surviving is a far better routing target than one fully drained.
        """
        if self.repartition_remaining_min <= 0.0:
            return 0
        return self._snap.stalled_slots

    @property
    def stalled_fraction(self) -> float:
        """``stalled_slots`` over the device's total slots, in [0, 1]."""
        return min(self.stalled_slots / self.profile.total_slots, 1.0)

    @property
    def free_slices(self) -> int:
        """Unoccupied slices of the *current* partition (0 mid-repartition)."""
        snap = self._snap
        if snap.repartitioning:
            return 0
        return max(snap.num_slices - snap.running, 0)

    @property
    def partition(self):
        """The device's current :class:`~repro_torch.core.slices.Partition`."""
        return self.profile.configs[self._snap.config_id]

    def free_geometry(self) -> Optional[FreeSlotGeometry]:
        """Free-slot geometry of the current partition (DESIGN.md §9).

        ``None`` mid-repartition: the partition is in flux and its free
        cells are not placeable until the rebuild lands.
        """
        snap = self._snap
        if snap.repartitioning:
            return None
        return free_slot_geometry(
            self.partition,
            snap.occupied_slices,
            total_slots=self.profile.total_slots,
            slice_sizes=self.profile.slice_sizes,
        )


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """Everything a dispatcher observes when routing one arrival.

    One typed argument instead of the historical ``(job, t, states)``
    triple-with-two-meanings: ``devices`` holds one :class:`DeviceState`
    per fleet member (fluid estimates or live engine views), and
    ``online`` says which — replacing the implicit contract where a
    dispatcher had to know which execution mode it was wired into.
    """

    t: float
    job: Job
    devices: Sequence[DeviceState]
    online: bool = True

    def __len__(self) -> int:
        return len(self.devices)

    def indices(self) -> range:
        return range(len(self.devices))

    def marginal_watts(self, i: int) -> float:
        """Marginal power (W) of one more busy slot on device ``i``."""
        st = self.devices[i]
        power = st.profile.power
        busy = st.est_busy_slots()
        total = float(st.profile.total_slots)
        return power.power_watts(min(busy + 1.0, total)) - power.power_watts(busy)


class Dispatcher(Protocol):
    """Routing strategy: picks a device index per arriving job."""

    name: str

    def pick(self, ctx: DispatchContext) -> int:
        """Device index for the arrival described by ``ctx``."""
        ...


class RoundRobinDispatcher:
    """Arrival index modulo fleet size — the order-only baseline."""

    name = "round-robin"

    def __init__(self) -> None:
        self._k = 0

    def pick(self, ctx: DispatchContext) -> int:
        """Next device in rotation, ignoring load and hardware."""
        i = self._k % len(ctx.devices)
        self._k += 1
        return i


class LeastLoadedDispatcher:
    """Smallest normalized backlog (backlog over peak slot count)."""

    name = "least-loaded"

    def pick(self, ctx: DispatchContext) -> int:
        """Device with the least estimated work per unit of capacity."""
        return min(
            ctx.indices(), key=lambda i: (ctx.devices[i].normalized_load, i)
        )


class EnergyGreedyDispatcher:
    """Marginal-power packing over the concave per-device power curves.

    Pure marginal-power packing degenerates: a saturated device has marginal
    power ~0 and would absorb every job forever while the rest of the fleet
    idles and tardiness grows without bound.  The spill threshold caps the
    estimated backlog a device may hold before it stops being a packing
    candidate; a fully saturated fleet falls back to least-loaded.
    """

    name = "energy-greedy"

    #: estimated backlog (device-minutes) beyond which a device stops
    #: accepting packed work and the dispatcher spills to the next device
    SPILL_BACKLOG_MIN = 30.0

    def pick(self, ctx: DispatchContext) -> int:
        """Open device with the cheapest marginal watt for one more slot."""
        open_devices = [
            i for i in ctx.indices()
            if ctx.devices[i].normalized_load < self.SPILL_BACKLOG_MIN
        ]
        if not open_devices:  # whole fleet saturated: protect tardiness
            return min(
                ctx.indices(), key=lambda i: (ctx.devices[i].normalized_load, i)
            )
        return min(open_devices, key=lambda i: (ctx.marginal_watts(i), i))


class StateAwareDispatcher:
    """Online-only routing on real device state (queue, partition, stalls).

    Scores each device by an expected-start-delay proxy the fluid estimate
    cannot compute:

    ``delay = normalized_load + repartition_remaining · stalled_fraction
    + congestion``

    where ``normalized_load`` is the device's *actual* outstanding work over
    its peak drain rate, ``repartition_remaining`` the minutes an in-flight
    repartition keeps slots stalled — weighted by the snapshot's
    ``stalled_slots`` share of the device, because under partial
    repartitioning the surviving slices keep serving and a mostly-surviving
    transition barely delays an arrival — and ``congestion`` a
    one-device-minute step when the current partition has no free slice
    (the job must wait for a completion or preemption rather than starting
    immediately).  Ties break toward the cheaper marginal watt at the
    device's current busy slots, then the lower index — so on an idle
    fleet it packs like ``energy-greedy``, but never onto a device that is
    visibly congested or mid-way through a full rebuild.

    Requires online dispatch (``requires_online``): the fluid two-phase
    mode has no partition or repartition state to read.
    """

    name = "state-aware"
    requires_online = True

    #: added delay (device-minutes) when no slice of the current partition
    #: is free — the job cannot start before a completion frees one
    CONGESTION_STEP_MIN = 1.0

    def start_delay(self, ctx: DispatchContext, i: int) -> float:
        """The expected-start-delay proxy for device ``i`` (device-minutes)."""
        st = ctx.devices[i]
        delay = (
            st.normalized_load
            + st.repartition_remaining_min * st.stalled_fraction
        )
        if st.free_slices == 0:
            delay += self.CONGESTION_STEP_MIN
        return delay

    def pick(self, ctx: DispatchContext) -> int:
        """Device minimizing (expected start delay, marginal watts, index)."""
        return min(
            ctx.indices(),
            key=lambda i: (self.start_delay(ctx, i), ctx.marginal_watts(i), i),
        )


class FragmentationAwareDispatcher(StateAwareDispatcher):
    """Serving dispatcher: slice-class fit first, fragmentation second.

    Extends the state-aware start-delay proxy with two geometry terms read
    off the device's free-slot geometry (DESIGN.md §9):

    * **misfit** — the arriving request wants a slice of its demand class
      (:func:`job_demand_slots`; serving tenants are capped at their model's
      slice class).  If the widest placeable instance on the device is
      narrower, the request would run slowed by ``demand / placeable``; the
      excess slowdown, scaled by the request's on-class service minutes, is
      charged as extra start delay.  A device that cannot place anything
      (or is mid-repartition) is charged as if the request ran on 1 slot.
    * **fragmentation** — the post-placement fragmentation ratio: the
      geometry is recomputed with the request's would-be instance carved
      out, and its ``1 - max_placeable/free`` (in [0, 1]) is added with a
      small weight.  Between two devices that can both serve the request
      now, prefer the one whose *remaining* free region stays usable for
      the next large request — the 2512.16099 packing rule.

    Ties still break toward the cheaper marginal watt, so on an idle fleet
    it packs onto low-power devices exactly like ``state-aware``.
    """

    name = "fragmentation-aware"
    requires_online = True

    #: weight (device-minutes per unit ratio) of post-placement fragmentation
    FRAG_WEIGHT_MIN = 2.0

    def geometry_delay(self, ctx: DispatchContext, i: int) -> float:
        """Misfit + post-placement fragmentation charge for device ``i``."""
        st = ctx.devices[i]
        demand = min(job_demand_slots(ctx.job), st.profile.total_slots)
        geo = st.free_geometry()
        widest = geo.max_placeable_slots if geo is not None else 0
        fit = max(min(widest, demand), 1)
        # excess service minutes from running below the demand class
        on_class = ctx.job.work / demand
        misfit = ctx.job.work / fit - on_class
        frag_after = 0.0
        if geo is not None and widest >= demand:
            placed = _place_in(geo, demand)
            frag_after = placed.fragmentation
        return misfit + self.FRAG_WEIGHT_MIN * frag_after

    def pick(self, ctx: DispatchContext) -> int:
        """Device minimizing (start delay + geometry terms, watts, index)."""
        return min(
            ctx.indices(),
            key=lambda i: (
                self.start_delay(ctx, i) + self.geometry_delay(ctx, i),
                ctx.marginal_watts(i),
                i,
            ),
        )


def _place_in(geo: FreeSlotGeometry, slots: int) -> FreeSlotGeometry:
    """Geometry after carving a ``slots``-wide instance at its best fit.

    Best fit = the placeable start whose run has the least leftover space
    (first such start on ties) — the packing a placement-aware controller
    would choose.  Requires the instance to be placeable in ``geo``.
    """
    best: Optional[Tuple[int, int, int]] = None  # (leftover, start, run idx)
    for k, (run_start, length) in enumerate(geo.runs):
        sub = FreeSlotGeometry(
            total_slots=geo.total_slots,
            runs=((run_start, length),),
            slice_sizes=geo.slice_sizes,
        )
        for s in sub.placeable_starts(slots):
            cand = (length - slots, s, k)
            if best is None or cand < best:
                best = cand
            break  # leftmost start in a run dominates later ones
    if best is None:
        raise ValueError(f"no placeable start for a {slots}-slot instance")
    _, start, k = best
    run_start, length = geo.runs[k]
    new_runs: List[Tuple[int, int]] = list(geo.runs[:k])
    if start > run_start:
        new_runs.append((run_start, start - run_start))
    tail = run_start + length - (start + slots)
    if tail > 0:
        new_runs.append((start + slots, tail))
    new_runs.extend(geo.runs[k + 1:])
    return FreeSlotGeometry(
        total_slots=geo.total_slots,
        runs=tuple(new_runs),
        slice_sizes=geo.slice_sizes,
    )


DISPATCHERS: Dict[str, Callable[[], Dispatcher]] = {
    "round-robin": RoundRobinDispatcher,
    "least-loaded": LeastLoadedDispatcher,
    "energy-greedy": EnergyGreedyDispatcher,
    "state-aware": StateAwareDispatcher,
    "fragmentation-aware": FragmentationAwareDispatcher,
}


class _LegacyDispatcherAdapter:
    """Wraps a pre-context dispatcher (``pick(job, t, states)``) as one.

    The adapter forwards ``name`` / ``requires_online`` so registry checks
    and trace labels see the wrapped dispatcher's identity.
    """

    def __init__(self, inner) -> None:
        self.inner = inner
        self.name = getattr(inner, "name", type(inner).__name__)
        self.requires_online = getattr(inner, "requires_online", False)

    def pick(self, ctx: DispatchContext) -> int:
        return self.inner.pick(ctx.job, ctx.t, ctx.devices)


def as_context_dispatcher(dispatcher) -> Dispatcher:
    """Return a dispatcher guaranteed to accept :class:`DispatchContext`.

    Registry dispatchers pass through; an object whose ``pick`` still has
    the pre-context ``(job, t, states)`` arity is wrapped in a deprecation
    shim.  This keeps external dispatchers working while every internal
    call site speaks the context API.
    """
    try:
        params = [
            p
            for p in inspect.signature(dispatcher.pick).parameters.values()
            if p.kind
            in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
        ]
    except (TypeError, ValueError):  # builtins/partials: assume context API
        return dispatcher
    if len(params) >= 3:
        warnings.warn(
            f"dispatcher {getattr(dispatcher, 'name', dispatcher)!r} uses the "
            "deprecated pick(job, t, states) signature; migrate to "
            "pick(ctx: DispatchContext)",
            DeprecationWarning,
            stacklevel=2,
        )
        return _LegacyDispatcherAdapter(dispatcher)
    return dispatcher


def make_dispatcher(name: str) -> Dispatcher:
    """Fresh dispatcher instance by registry name (they carry state)."""
    try:
        return DISPATCHERS[name]()
    except KeyError as e:
        raise KeyError(
            f"unknown dispatcher {name!r}; registered: {sorted(DISPATCHERS)}"
        ) from e


#: dispatch-time load records: (t, per-device backlog in 1g-minutes) after
#: each routing decision — the fleet-aware RL observation reads this.
DispatchTrace = List[Tuple[float, Tuple[float, ...]]]


def dispatch_jobs(
    jobs: Sequence[Job],
    profiles: Sequence[DeviceProfile],
    dispatcher: Dispatcher,
) -> Tuple[List[int], DispatchTrace]:
    """Route every job to a device index; returns (assignments, trace).

    Jobs must be sorted by arrival (workload generators guarantee it); the
    fluid states are drained to each arrival before the dispatcher looks.
    Dispatchers that read real engine state (``requires_online``) cannot
    run against the fluid estimate and are rejected here.
    """
    dispatcher = as_context_dispatcher(dispatcher)
    if getattr(dispatcher, "requires_online", False):
        raise ValueError(
            f"dispatcher {dispatcher.name!r} reads real device state and "
            "cannot run in fluid mode"
        )
    states = [DeviceLoadState(index=i, profile=p) for i, p in enumerate(profiles)]
    assignments: List[int] = []
    trace: DispatchTrace = []
    prev_arrival = 0.0
    for job in jobs:
        if job.arrival < prev_arrival - 1e-9:
            raise ValueError("dispatch_jobs requires arrival-sorted jobs")
        prev_arrival = job.arrival
        for st in states:
            st.drain_to(job.arrival)
        ctx = DispatchContext(t=job.arrival, job=job, devices=states, online=False)
        i = dispatcher.pick(ctx)
        if not (0 <= i < len(states)):
            raise IndexError(f"dispatcher {dispatcher.name} picked device {i}")
        states[i].backlog_1g_min += job.work
        states[i].dispatched += 1
        assignments.append(i)
        trace.append((job.arrival, tuple(st.backlog_1g_min for st in states)))
    return assignments, trace
