"""The long-running scheduler service (docs/SERVICE.md, DESIGN.md §10).

:class:`SchedulerService` wraps one stream-open
:class:`~repro_torch.core.engine.SimulationEngine` (or, in fleet mode, a
:class:`~repro_torch.fleet.simulator.FleetStream`) behind a
submit / status / cancel / reconfigure API and makes it durable:

* every state-changing op is applied, then appended to a write-ahead log
  (:mod:`repro_torch.service.wal`) **before** it is acknowledged;
* each op record carries the sim-time ``t`` it was applied at; applying an
  op always means *advance the engine to* ``t`` *(exclusive), then act* —
  the one protocol shared by the live path and replay;
* periodically the whole service state (engine included) is pickled into an
  atomic checkpoint (:mod:`repro_torch.service.checkpoint`) and the WAL is
  truncated;
* crash recovery = newest checkpoint + WAL tail replay.  Because
  ``run_until`` is chunk-invariant (events are processed in time order no
  matter how the advances are sliced) and every op's effect depends only on
  engine state at its recorded ``t``, the recovered service is
  **bit-identical** to one that never crashed — the load-bearing invariant,
  pinned against the JAX package by ``tests/test_torch_service_recovery.py``.

Idle ticks (:meth:`tick`) advance the engine to the replay clock's reading
but are *not* logged: by chunk-invariance they are invisible to the final
state, which is exactly why recovery doesn't need to reproduce wall-clock
pacing.

Memory stays bounded over multi-day streams: at every checkpoint (and at
close) completed/cancelled jobs are folded out of the engine
(:meth:`SimulationEngine.harvest_completed`) into :class:`ServiceStats`,
whose incremental math reproduces ``SimulationEngine.result()``
float-for-float (same additions, same order).

The port's own copy of ``repro.service.service``: host code with the
reference's order of operations, so the same ops give ``==`` results in both
packages, and a workdir's header and WAL (``WAL_FORMAT`` 1) read in either.
A checkpoint pickles the package's own classes, so it restores only in the
package that wrote it.  The service does no device work.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.engine import SimulationEngine
from repro_torch.core.jobs import Job, JobKind, elasticity_from_label
from repro_torch.core.metrics import SimResult, TenantSLOStats
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import (
    DayNightPolicy,
    MIGSimulator,
    NoMIGPolicy,
    RepartitionPolicy,
    StaticPolicy,
)
from repro_torch.core.slices import MIG_CONFIGS
from repro_torch.fleet.devices import device_profile
from repro_torch.fleet.simulator import (
    DeviceAdaptedPolicy,
    FleetResult,
    FleetSimulator,
    FleetSpec,
    FleetStream,
)
from repro_torch.service.checkpoint import CheckpointStore
from repro_torch.service.clock import ReplayClock
from repro_torch.service.records import (
    WAL_FORMAT,
    job_from_dict,
    job_to_dict,
    validate_record,
)
from repro_torch.service.wal import WriteAheadLog, read_wal

__all__ = [
    "POLICY_SPECS",
    "make_policy",
    "ServiceConfig",
    "ServiceStats",
    "SchedulerService",
    "sim_result_to_dict",
]

_HEADER = "service.json"
_WAL = "wal.jsonl"

#: policy spec grammar accepted by :func:`make_policy`
POLICY_SPECS = (
    "static[:CONFIG]",
    "nomig",
    "daynight[:DAY,NIGHT]",
    "heuristic",
    "forecast",
)


def make_policy(spec: str, *, repartition_mode: str = "partial") -> RepartitionPolicy:
    """Build a repartition policy from a registry spec string.

    Every policy this returns is picklable (a service checkpoint contains
    the policy's live state), which is why the service accepts specs, not
    policy objects — ``CallbackPolicy`` closures can't checkpoint.
    Each call returns a *fresh* instance: policies carry per-run state and
    must never be shared across devices.
    """
    name, _, arg = spec.partition(":")
    if name == "static":
        return StaticPolicy(config_id=int(arg) if arg else 3)
    if name == "nomig":
        return NoMIGPolicy()
    if name == "daynight":
        if arg:
            day, night = (int(x) for x in arg.split(","))
            return DayNightPolicy(day_config=day, night_config=night)
        return DayNightPolicy()
    if name == "heuristic":
        from repro_torch.launch.cluster_sim import QueueHeuristicPolicy

        return QueueHeuristicPolicy()
    if name == "forecast":
        from repro_torch.forecast.policy import ForecastPolicy

        return ForecastPolicy(repartition_mode=repartition_mode)
    raise ValueError(
        f"unknown policy spec {spec!r}; valid specs: {POLICY_SPECS}"
    )


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Immutable service configuration, persisted as the workdir header.

    ``fleet_profiles=None`` runs one device (``profile``); a tuple of
    profile names runs a fleet behind ``dispatcher``.  ``policy="nomig"``
    implies ``mig_enabled=False`` (the NoMIG benchmark semantics).
    ``checkpoint_every_min`` is in **sim** minutes; ``0`` disables the
    cadence (explicit :meth:`SchedulerService.checkpoint` still works).
    """

    scheduler: str = "EDF-SS"
    policy: str = "daynight"
    profile: str = "a100-250w"
    repartition_mode: str = "partial"
    initial_config: Optional[int] = None
    mig_enabled: bool = True
    checkpoint_every_min: float = 60.0
    wal_fsync: bool = False
    fleet_profiles: Optional[Tuple[str, ...]] = None
    dispatcher: str = "least-loaded"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.fleet_profiles is not None:
            d["fleet_profiles"] = list(self.fleet_profiles)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServiceConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"service header has unknown config keys {sorted(unknown)}; "
                f"this workdir was written by an incompatible version"
            )
        d = dict(d)
        if d.get("fleet_profiles") is not None:
            d["fleet_profiles"] = tuple(d["fleet_profiles"])
        return cls(**d)


@dataclasses.dataclass
class ServiceStats:
    """Running aggregates over harvested jobs (single-device mode).

    The fold is performed in completion order starting from the same
    zeros as :meth:`SimulationEngine.result`, so the incremental totals
    are *bit-identical* to the one-shot sums no matter how the stream of
    completions is chunked across checkpoints (left-fold float addition
    is associative-by-construction here because the addition sequence is
    literally the same).
    """

    SCHEMA_VERSION = 1  # the reference's field set, version 1 (repro_torch.lint SD001/SD002)
    _schema_digest = "2623a1e3"

    num_completed: int = 0
    num_cancelled: int = 0
    total_tardiness: float = 0.0
    max_tardiness: float = 0.0
    deadline_misses: int = 0
    tenant_acc: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def fold(self, completed: List[Job], cancelled: List[Job]) -> None:
        """Absorb one harvest batch (jobs arrive in completion order)."""
        for j in completed:
            self.num_completed += 1
            tard = j.tardiness()
            self.total_tardiness += tard
            self.max_tardiness = max(self.max_tardiness, tard)
            if tard > 1e-9:
                self.deadline_misses += 1
            if j.tenant is not None:
                acc = self.tenant_acc.setdefault(j.tenant, [0, 0, 0.0])
                acc[0] += 1
                acc[1] += 1 if j.slo_attained() else 0
                acc[2] += j.latency()
        self.num_cancelled += len(cancelled)

    def result(self, sim: MIGSimulator) -> SimResult:
        """The final :class:`SimResult`, mirroring ``engine.result()``.

        ``sim`` supplies the device-side accumulators (energy, busy-slot
        integral, preemption/repartition counters, makespan) that are not
        per-job quantities.
        """
        if sim.active:
            raise RuntimeError(
                f"simulation ended with {len(sim.active)} unfinished jobs"
            )
        m = max(self.num_completed, 1)
        tenants = {
            name: TenantSLOStats(
                jobs=int(acc[0]), attained=int(acc[1]), latency_sum_min=acc[2]
            )
            for name, acc in sorted(self.tenant_acc.items())
        }
        extra = {
            "makespan_min": sim.t,
            "tardiness_integral": sim.tardiness_integral,
        }
        if self.num_cancelled:
            extra["cancelled_jobs"] = float(self.num_cancelled)
        return SimResult(
            energy_wh=sim.energy_wh,
            avg_tardiness=self.total_tardiness / m,
            num_jobs=self.num_completed,
            total_tardiness=self.total_tardiness,
            preemptions=sim.preemptions,
            repartitions=sim.repartitions,
            max_tardiness=self.max_tardiness,
            deadline_misses=self.deadline_misses,
            busy_slot_minutes=sim.busy_slot_minutes,
            extra=extra,
            tenants=tenants,
        )


def sim_result_to_dict(res: SimResult) -> Dict[str, Any]:
    """JSON-safe view of a :class:`SimResult` (CLI / server responses)."""
    return {
        "energy_wh": res.energy_wh,
        "avg_tardiness": res.avg_tardiness,
        "num_jobs": res.num_jobs,
        "total_tardiness": res.total_tardiness,
        "preemptions": res.preemptions,
        "repartitions": res.repartitions,
        "max_tardiness": res.max_tardiness,
        "deadline_misses": res.deadline_misses,
        "busy_slot_minutes": res.busy_slot_minutes,
        "extra": dict(res.extra),
        "tenants": {
            name: {
                "jobs": st.jobs,
                "attained": st.attained,
                "latency_sum_min": st.latency_sum_min,
            }
            for name, st in res.tenants.items()
        },
    }


class SchedulerService:
    """One durable scheduling session over a workdir; see module docstring.

    Constructing against an empty directory **creates** a fresh service
    (writing the config header); constructing against a directory that
    already holds a header **recovers** — newest checkpoint, then WAL tail.
    ``config`` may be omitted on recovery (the header's is used) and, if
    given, must match it.

    The service is single-threaded by design: ops are applied and logged
    in one call frame, so a checkpoint can never observe a half-applied
    operation.
    """

    def __init__(
        self,
        workdir: Union[str, Path],
        config: Optional[ServiceConfig] = None,
        *,
        clock: Optional[ReplayClock] = None,
        checkpoint_keep: int = 2,
    ) -> None:
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        header = self.workdir / _HEADER
        existing = header.exists()
        if existing:
            stored = ServiceConfig.from_dict(
                json.loads(header.read_text(encoding="utf-8"))["config"]
            )
            if config is not None and config != stored:
                raise ValueError(
                    f"workdir {self.workdir} already holds a service with a "
                    f"different config; recover it with config=None or use a "
                    f"fresh directory"
                )
            config = stored
        else:
            config = config if config is not None else ServiceConfig()
            header.write_text(
                json.dumps(
                    {"format": WAL_FORMAT, "config": config.to_dict()},
                    indent=2,
                    sort_keys=True,
                )
                + "\n",
                encoding="utf-8",
            )
        self.config = config
        self.clock = clock
        self.ckpts = CheckpointStore(self.workdir, keep=checkpoint_keep)

        # state (overwritten by a checkpoint restore below)
        self.stats = ServiceStats()
        self.job_state: Dict[int, Tuple[str, float]] = {}
        self.known_jobs: set = set()
        self._max_job_id = -1
        self.applied_seq = 0
        self.applied_until = 0.0
        self.closed = False

        snap = self.ckpts.latest() if existing else None
        if snap is not None:
            self._restore(snap[1])
        else:
            self.backend = _build_backend(config)
        self._fleet = isinstance(self.backend, FleetStream)

        #: ops replayed from the WAL tail at construction (0 = clean start)
        self.recovered_ops = 0
        if existing:
            prev_seq = self.applied_seq
            for rec in read_wal(self.workdir / _WAL):
                validate_record(rec)
                if rec["seq"] <= self.applied_seq:
                    continue  # already covered by the checkpoint
                if rec["seq"] <= prev_seq:
                    raise ValueError(
                        f"WAL seq {rec['seq']} out of order after {prev_seq}"
                    )
                prev_seq = rec["seq"]
                self._apply_op(rec)
                self.applied_seq = rec["seq"]
                self.applied_until = max(self.applied_until, float(rec["t"]))
                self.recovered_ops += 1
        self._next_seq = self.applied_seq + 1
        self.wal = WriteAheadLog(self.workdir / _WAL, fsync=config.wal_fsync)
        self._last_ckpt_t = self.applied_until
        if self.clock is not None:
            self.clock.resync(self.applied_until)

    # ------------------------------------------------------------------
    # construction helpers

    @classmethod
    def recover(
        cls,
        workdir: Union[str, Path],
        *,
        clock: Optional[ReplayClock] = None,
    ) -> "SchedulerService":
        """Recover an existing service (refuses a directory with none)."""
        if not (Path(workdir) / _HEADER).exists():
            raise FileNotFoundError(
                f"no service header in {workdir}; nothing to recover"
            )
        return cls(workdir, clock=clock)

    def _restore(self, blob: bytes) -> None:
        payload = pickle.loads(blob)
        if payload.get("format") != WAL_FORMAT:
            raise ValueError(
                f"checkpoint format {payload.get('format')} != {WAL_FORMAT}"
            )
        self.backend = payload["backend"]
        self.stats = payload["stats"]
        self.job_state = payload["job_state"]
        self.known_jobs = payload["known_jobs"]
        self._max_job_id = payload["max_job_id"]
        self.applied_seq = payload["applied_seq"]
        self.applied_until = payload["applied_until"]
        self.closed = payload["closed"]

    # ------------------------------------------------------------------
    # time

    def now(self) -> float:
        """The service's sim-time frontier: never before any applied op."""
        t = self.applied_until
        if self.clock is not None and self.clock.paced:
            t = max(t, self.clock.now())
        return t

    def _advance(self, t: float) -> int:
        """Advance the backend to ``t`` (exclusive) — the op protocol."""
        if self._fleet:
            return self.backend.run_until(t)
        return self.backend.run_until(t, inclusive=False)

    def _engines(self) -> List[SimulationEngine]:
        return self.backend.engines if self._fleet else [self.backend]

    # ------------------------------------------------------------------
    # the one apply path (live ops and WAL replay share it verbatim)

    def _apply_op(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        op, t = rec["op"], float(rec["t"])
        self._advance(t)
        if op == "submit":
            job = job_from_dict(rec["job"])
            if self._fleet:
                device = self.backend.submit(job)
            else:
                self.backend.inject(job)
                device = 0
            self.known_jobs.add(job.job_id)
            self._max_job_id = max(self._max_job_id, job.job_id)
            return {"job_id": job.job_id, "device": device, "state": "submitted"}
        if op == "cancel":
            jid = int(rec["job_id"])
            disposition = self.backend.cancel(jid)
            self.job_state[jid] = ("cancelled", t)
            return {"job_id": jid, "disposition": disposition}
        if op == "reconfigure":
            cfg = int(rec["config"])
            dev = int(rec.get("device", 0))
            engines = self._engines()
            if not (0 <= dev < len(engines)):
                raise ValueError(
                    f"cannot reconfigure device {dev}: the service has "
                    f"{len(engines)} device(s)"
                )
            changed = engines[dev].reconfigure(cfg)
            return {"config": cfg, "device": dev, "changed": changed}
        # close: end the stream and drain every engine to completion
        if self._fleet:
            self.backend.close()
        else:
            self.backend.close_stream()
            self.backend.drain()
        self.closed = True
        self._harvest()
        self.applied_until = max(
            self.applied_until, max(e.sim.t for e in self._engines())
        )
        return {"closed": True, "t_final": self.applied_until}

    def _commit(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """Apply, then durably log, then acknowledge (in that order).

        Applying first means an invalid op (bad id, closed stream, config
        not in the table) raises *before* anything reaches the WAL — the
        log only ever contains ops that succeeded, so replay cannot fail
        where the live run did not.
        """
        out = self._apply_op(rec)
        rec["seq"] = self._next_seq
        self.wal.append(rec)
        self.applied_seq = rec["seq"]
        self._next_seq += 1
        self.applied_until = max(self.applied_until, float(rec["t"]))
        self._maybe_checkpoint()
        return out

    def _require_open(self, what: str) -> None:
        if self.closed:
            raise RuntimeError(
                f"cannot {what}: the service stream was closed at "
                f"t={self.applied_until}; results are final "
                f"(start a new workdir for a new session)"
            )

    # ------------------------------------------------------------------
    # public ops

    def submit(self, job: Job, *, restamp: bool = False) -> Dict[str, Any]:
        """Submit one job; returns ``{job_id, device, state}``.

        The arrival may not precede the service frontier (ops are applied
        in nondecreasing sim-time).  ``restamp=True`` (the server/CLI
        default) moves a too-early arrival up to the frontier, preserving
        the deadline *slack*; ``restamp=False`` (the replay/test path)
        rejects it instead.
        """
        self._require_open("submit")
        if job.job_id in self.known_jobs:
            raise ValueError(
                f"cannot submit job {job.job_id}: that id was already "
                f"submitted to this service; ids must be unique for the "
                f"lifetime of the workdir (check `status --job` first)"
            )
        floor = self.now()
        if job.arrival + 1e-9 < floor:
            if not restamp:
                raise ValueError(
                    f"cannot submit job {job.job_id}: arrival t={job.arrival} "
                    f"is before the service frontier t={floor}; pass "
                    f"restamp=True to stamp it at the frontier (slack "
                    f"preserved)"
                )
            job = dataclasses.replace(
                job,
                arrival=floor,
                deadline=job.deadline + (floor - job.arrival),
            )
        rec = {"op": "submit", "t": job.arrival, "job": job_to_dict(job)}
        return self._commit(rec)

    def submit_request(
        self, fields: Dict[str, Any], *, restamp: bool = True
    ) -> Dict[str, Any]:
        """Build a job from client-side fields and submit it (server path).

        Recognized fields: ``work`` (1g-minutes, default 10), ``kind``
        (``inference``/``training``), ``elasticity`` (label),
        ``deadline`` (absolute min) or ``deadline_slack_min`` (default 60,
        relative to arrival), ``arrival`` (default: the frontier),
        ``job_id`` (default: auto), ``speedup_no_mig``, ``tenant``,
        ``slo_min``.
        """
        arrival = float(fields.get("arrival", self.now()))
        deadline = fields.get("deadline")
        if deadline is None:
            deadline = arrival + float(fields.get("deadline_slack_min", 60.0))
        job = Job(
            job_id=int(fields.get("job_id", self._max_job_id + 1)),
            kind=JobKind(fields.get("kind", "inference")),
            arrival=arrival,
            work=float(fields.get("work", 10.0)),
            deadline=float(deadline),
            elasticity=elasticity_from_label(fields.get("elasticity", "linear")),
            speedup_no_mig=float(fields.get("speedup_no_mig", 1.0)),
            tenant=fields.get("tenant"),
            slo_min=fields.get("slo_min"),
        )
        return self.submit(job, restamp=restamp)

    def cancel(self, job_id: int) -> Dict[str, Any]:
        """Cancel a job; returns its disposition (see ``engine.cancel``).

        The service validates against its own lifetime records first: a
        job folded out by a harvest no longer exists inside the engine,
        whose error ("never injected") would be misleading here.
        """
        self._require_open("cancel")
        jid = int(job_id)
        if jid not in self.known_jobs:
            raise ValueError(
                f"cannot cancel job {jid}: it was never submitted to this "
                f"service; check `status --job {jid}` for its disposition"
            )
        terminal = self.job_state.get(jid)
        if terminal is not None:
            raise ValueError(
                f"cannot cancel job {jid}: it already reached terminal "
                f"state {terminal[0]!r} at t={terminal[1]}; only "
                f"pending/queued/running jobs can be cancelled"
            )
        return self._commit({"op": "cancel", "t": self.now(), "job_id": jid})

    def reconfigure(self, config: int, device: int = 0) -> Dict[str, Any]:
        """Manually repartition a device now (same stall as a policy move)."""
        self._require_open("reconfigure")
        return self._commit(
            {
                "op": "reconfigure",
                "t": self.now(),
                "config": int(config),
                "device": int(device),
            }
        )

    def close(self) -> Dict[str, Any]:
        """End the arrival stream and drain to completion (logged op)."""
        self._require_open("close")
        return self._commit({"op": "close", "t": self.now()})

    def tick(self) -> int:
        """Advance to the replay clock's reading; returns events processed.

        Not logged: chunk-invariance makes tick boundaries invisible to
        the final state, so replay needn't reproduce wall-clock pacing.
        Also runs the checkpoint cadence.
        """
        if self.closed:
            return 0
        t = self.now()
        n = 0
        if t > self.applied_until:
            n = self._advance(t)
            self.applied_until = t
        self._maybe_checkpoint()
        return n

    # ------------------------------------------------------------------
    # checkpointing / memory compaction

    def _harvest(self) -> None:
        """Fold finished jobs out of the engine into :class:`ServiceStats`.

        Single-device mode only: fleet engines keep their jobs so the
        fleet's per-device ``result()`` path stays intact.
        """
        if self._fleet:
            return
        done, cancelled = self.backend.harvest_completed()
        self.stats.fold(done, cancelled)
        for j in done:
            self.job_state[j.job_id] = ("completed", j.completion)
        for j in cancelled:
            # the cancel op already recorded the terminal state (keep its t)
            self.job_state.setdefault(j.job_id, ("cancelled", self.applied_until))

    def _maybe_checkpoint(self) -> None:
        every = self.config.checkpoint_every_min
        if every > 0 and self.applied_until - self._last_ckpt_t >= every:
            self.checkpoint()

    def checkpoint(self) -> Path:
        """Snapshot the full service state and truncate the WAL.

        Every logged op is applied before it is logged, so at this point
        the snapshot covers the entire WAL — rotation empties it.
        """
        self._harvest()
        payload = {
            "format": WAL_FORMAT,
            "applied_seq": self.applied_seq,
            "applied_until": self.applied_until,
            "closed": self.closed,
            "backend": self.backend,
            "stats": self.stats,
            "job_state": self.job_state,
            "known_jobs": self.known_jobs,
            "max_job_id": self._max_job_id,
        }
        try:
            blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:
            raise ValueError(
                f"service state is not picklable ({e}); checkpointing "
                f"requires registry policies/schedulers "
                f"(repro_torch.service.make_policy)"
            ) from e
        path = self.ckpts.save(blob, self.applied_seq)
        self.wal.rotate(())
        self._last_ckpt_t = self.applied_until
        return path

    # ------------------------------------------------------------------
    # observation / results

    def status(self, job_id: Optional[int] = None) -> Dict[str, Any]:
        """Service summary, or one job's disposition when ``job_id`` given."""
        if job_id is not None:
            return self.job_status(int(job_id))
        snaps = [e.sim.snapshot() for e in self._engines()]
        live_cancelled = sum(len(e.sim.cancelled) for e in self._engines())
        return {
            "t": self.applied_until,
            "applied_seq": self.applied_seq,
            "closed": self.closed,
            "devices": len(snaps),
            "configs": [s.config_id for s in snaps],
            "submitted": len(self.known_jobs),
            "completed": self.stats.num_completed
            + sum(s.completed_jobs for s in snaps),
            "cancelled": self.stats.num_cancelled + live_cancelled,
            "queue_depth": sum(s.queue_depth for s in snaps),
            "running": sum(s.running for s in snaps),
            "energy_wh": sum(s.energy_wh for s in snaps),
            "recovered_ops": self.recovered_ops,
        }

    def job_status(self, job_id: int) -> Dict[str, Any]:
        """One job's disposition: pending/queued/running/completed/cancelled."""
        if job_id not in self.known_jobs:
            return {"job_id": job_id, "state": "unknown"}
        terminal = self.job_state.get(job_id)
        if terminal is not None:
            return {"job_id": job_id, "state": terminal[0], "t": terminal[1]}
        if self._fleet:
            device = self.backend.owner.get(job_id)
            state = (
                self.backend.engines[device].job_disposition(job_id)
                if device is not None
                else None
            )
        else:
            device = 0
            state = self.backend.job_disposition(job_id)
        return {"job_id": job_id, "state": state or "unknown", "device": device}

    def result(self) -> SimResult:
        """Final aggregate result; requires a closed (drained) stream."""
        if not self.closed:
            raise RuntimeError(
                "the service stream is still open; close() it (draining "
                "every queued job) before reading the final result"
            )
        if self._fleet:
            return self.backend.result().aggregate
        return self.stats.result(self.backend.sim)

    def fleet_result(self) -> FleetResult:
        """Full per-device fleet result (fleet mode only)."""
        if not self._fleet:
            raise RuntimeError(
                "this service runs a single device; use result()"
            )
        if not self.closed:
            raise RuntimeError(
                "the service stream is still open; close() it first"
            )
        return self.backend.result()

    def shutdown(self) -> None:
        """Checkpoint and release file handles (clean process exit)."""
        self.checkpoint()
        self.wal.close()


def _build_backend(config: ServiceConfig):
    """One stream-open engine, or a FleetStream, per the config."""
    mig_enabled = config.mig_enabled and config.policy.partition(":")[0] != "nomig"
    if config.fleet_profiles:
        spec = FleetSpec.of(
            config.fleet_profiles,
            dispatcher=config.dispatcher,
            scheduler=config.scheduler,
            repartition_mode=config.repartition_mode,
        )
        fleet = FleetSimulator(spec, mig_enabled=mig_enabled)
        policy_spec, mode = config.policy, config.repartition_mode
        return fleet.open_stream(
            lambda i, prof: make_policy(policy_spec, repartition_mode=mode)
        )
    prof = device_profile(config.profile)
    sim = MIGSimulator(
        make_scheduler(config.scheduler),
        power_model=prof.power,
        mig_enabled=mig_enabled,
        config_table=prof.configs,
        repartition_mode=config.repartition_mode,
    )
    policy = make_policy(config.policy, repartition_mode=config.repartition_mode)
    if set(prof.configs) != set(MIG_CONFIGS):
        policy = DeviceAdaptedPolicy(policy, prof.configs)
    return SimulationEngine(
        sim,
        policy=policy,
        initial_config=config.initial_config,
        stream_open=True,
    )
