"""Sweep cells: the unit of work of the sweep engine, and the policy registry.

A *cell* is one simulator run, described entirely by JSON-serializable data:

``{experiment, group, scheduler, policy, policy_kwargs, workload | scenario,
seed, mig_enabled, repartition_mode[, fleet][, backend, backend_kwargs]}``

* ``experiment`` names the grid and ``group`` the aggregation bucket inside it;
* ``policy`` + ``policy_kwargs`` name a registered repartitioning policy
  (:data:`POLICIES`);
* ``workload`` is the fully-resolved :class:`WorkloadSpec` field dict, or
  ``scenario`` a registered scenario with its resolved kwargs;
* ``seed`` drives the job stream, making the cell deterministic;
* ``fleet`` (fleet cells only) lists the devices by profile name, the
  dispatcher and what it observes (``info``);
* ``backend`` + ``backend_kwargs`` (batched cells only) route the cell
  through the batched simulator (:mod:`repro_torch.sweep.batched`).

:func:`cell_hash` is a content hash over the cell's physics plus the
simulator version tag (:data:`repro_torch.core.simulator.SIM_VERSION`); the
on-disk cache keys on it, so a semantics bump invalidates every memoized
result at once.  Cells and hashes are the reference's, key for key.

The port's own copy of ``repro.sweep.cells``.  :func:`run_cell` runs one
cell on the oracle (the event-driven :class:`MIGSimulator`, or
:class:`repro_torch.fleet.FleetSimulator` for a cell with a ``fleet`` key)
or, for ``backend == "batched"``, as a one-cell batch of
:func:`repro_torch.core.batched.simulate_batch`.  The registry's ``"dqn"``
runs its Q network on ``device`` (default: the CUDA card), as the batched
simulator does; everything else is float64 host code.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.metrics import SimResult, TenantSLOStats
from repro_torch.core.scenarios import generate_scenario, resolve_scenario_kwargs
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import (
    REPARTITION_MODES,
    SIM_VERSION,
    DayNightPolicy,
    MIGSimulator,
    NoMIGPolicy,
    RepartitionPolicy,
    StaticPolicy,
)
from repro_torch.core.workload import WorkloadSpec, generate_jobs
from repro_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:  # pragma: no cover
    import torch

__all__ = [
    "POLICIES",
    "CellSpec",
    "canonical_json",
    "cell_hash",
    "cell_jobs",
    "cell_repartition_mode",
    "file_digest",
    "group_results",
    "make_cell",
    "make_fleet_cell",
    "make_policy",
    "make_scenario_cell",
    "result_to_sim_result",
    "run_cell",
    "workload_to_dict",
]

Cell = Dict[str, Any]


def cell_repartition_mode(cell: Cell) -> str:
    """The transition model a cell runs under.

    Cells built since ``mig-sim-4`` carry the key explicitly; a cell without
    it predates slot placement and replays under the legacy full-drain model.
    """
    return cell.get("repartition_mode", "drain")


def _cell_policy_kwargs(cell: Cell) -> Dict[str, Any]:
    """The cell's policy kwargs, with mode-coupled defaults resolved.

    The forecast controller's MPC lookahead must price the same transition
    physics the simulator charges, so unless the cell pins the policy's
    ``repartition_mode`` explicitly it inherits the cell's simulator mode —
    in particular, legacy (pre-mig-sim-4) forecast cells replay with drain
    pricing, exactly as they originally ran.
    """
    kwargs = dict(cell.get("policy_kwargs") or {})
    if cell.get("policy") == "forecast":
        kwargs.setdefault("repartition_mode", cell_repartition_mode(cell))
    return kwargs


# ----------------------------------------------------------------------
# policy registry (name -> factory taking the cell's policy_kwargs)

def _dqn_policy(
    params_path: str,
    initial_config: int = 2,
    decision_interval_min: Optional[float] = None,
    *,
    device: DeviceLike = None,
) -> RepartitionPolicy:
    """Greedy DQN policy, its Q network on ``device`` (default: the card);
    ``decision_interval_min`` evaluates on the fixed cadence the batched
    trainer trains under (:mod:`repro_torch.core.rl.batched_train`)."""
    from repro_torch.core.rl import DQNConfig, DQNLearner, greedy_policy
    from repro_torch.core.rl.env import FEATURE_DIM

    learner = DQNLearner(DQNConfig(state_dim=FEATURE_DIM), device=device)
    learner.load(params_path)
    return greedy_policy(
        learner,
        initial_config=initial_config,
        decision_interval_min=decision_interval_min,
    )


def _heuristic_policy() -> RepartitionPolicy:
    from repro_torch.launch.cluster_sim import queue_heuristic_policy

    return queue_heuristic_policy()


def _forecast_policy(
    scenario: str = "paper-diurnal",
    train_seeds: int = 8,
    harmonics: int = 3,
    scenario_kwargs: Optional[Mapping[str, Any]] = None,
    **policy_kwargs: Any,
) -> RepartitionPolicy:
    """Predictive MPC controller, forecaster fitted on ``scenario``.

    The Fourier day-model fit is deterministic and cached per process
    (:func:`repro_torch.forecast.fit_scenario_forecaster`, keyed on the sorted
    kwargs tuple); the policy instance itself is fresh per cell (it carries
    EWMA/dwell state).
    """
    from repro_torch.forecast import ArrivalForecaster, ForecastPolicy, fit_scenario_forecaster

    model = fit_scenario_forecaster(
        scenario=scenario,
        train_seeds=train_seeds,
        harmonics=harmonics,
        scenario_kwargs=tuple(sorted(dict(scenario_kwargs or {}).items())),
    )
    return ForecastPolicy(ArrivalForecaster(model), **policy_kwargs)


POLICIES: Dict[str, Callable[..., RepartitionPolicy]] = {
    "static": lambda config_id=3: StaticPolicy(config_id),
    "nomig": lambda: NoMIGPolicy(),
    "daynight": lambda day_config=6, night_config=2: DayNightPolicy(
        day_config, night_config
    ),
    "heuristic": _heuristic_policy,
    "dqn": _dqn_policy,
    "forecast": _forecast_policy,
}


def make_policy(
    name: str,
    kwargs: Optional[Mapping[str, Any]] = None,
    *,
    device: DeviceLike = None,
) -> RepartitionPolicy:
    """Fresh policy instance from the registry (instances carry run state).

    ``device`` reaches the one policy that runs on a device, ``"dqn"``.
    """
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; registered: {sorted(POLICIES)}")
    # underscore-prefixed kwargs are hash-only annotations (e.g. the
    # reference's weights digest), not factory arguments
    clean = {k: v for k, v in dict(kwargs or {}).items() if not k.startswith("_")}
    if name == "dqn":
        clean["device"] = device
    return POLICIES[name](**clean)


# ----------------------------------------------------------------------
# cell construction + hashing

def file_digest(path: str) -> str:
    """Content digest of an auxiliary input file ('' when absent)."""
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return ""


def workload_to_dict(spec: WorkloadSpec) -> Dict[str, Any]:
    """All WorkloadSpec fields, fully resolved (defaults included).

    Resolving defaults into the cell means the hash captures the *values* the
    simulation saw — a changed default can never alias a stale cache entry.
    """
    return dataclasses.asdict(spec)


def _base_cell(
    *,
    experiment: str,
    group: str,
    scheduler: str,
    seed: int,
    policy: str,
    policy_kwargs: Optional[Mapping[str, Any]],
    mig_enabled: bool,
    repartition_mode: str,
    backend: str = "oracle",
    backend_kwargs: Optional[Mapping[str, Any]] = None,
) -> Cell:
    """The fields every cell shares; workload/scenario keys are added on top.

    ``backend`` selects the simulation engine: ``"oracle"`` (the event-driven
    :class:`MIGSimulator`, the default) adds *no* keys, while ``"batched"``
    stamps the cell with ``backend`` plus its resolved ``backend_kwargs``
    (``dt_min``), so oracle and batched runs of the same physics never alias
    one cache entry.
    """
    if repartition_mode not in REPARTITION_MODES:
        raise ValueError(
            f"unknown repartition_mode {repartition_mode!r}; "
            f"valid: {REPARTITION_MODES}"
        )
    if backend not in ("oracle", "batched"):
        raise ValueError(
            f"unknown backend {backend!r}; valid: ('oracle', 'batched')"
        )
    if backend == "oracle" and backend_kwargs:
        raise ValueError("backend_kwargs only apply to the batched backend")
    policy_kwargs = dict(policy_kwargs or {})
    # Policies that load weights from disk are only content-addressable if the
    # weights themselves enter the hash: a retrained checkpoint at the same
    # path must miss the cache, not silently serve stale results.
    if "params_path" in policy_kwargs:
        policy_kwargs["_params_digest"] = file_digest(policy_kwargs["params_path"])
    cell: Cell = {
        "experiment": experiment,
        "group": group,
        "scheduler": scheduler,
        "policy": policy,
        "policy_kwargs": policy_kwargs,
        "seed": int(seed),
        "mig_enabled": bool(mig_enabled),
        # resolved explicitly into the cell (the hash must capture the mode
        # the simulator ran under); cells *without* the key are pre-mig-sim-4
        # and replay under the legacy drain model (see run_cell)
        "repartition_mode": repartition_mode,
    }
    if backend == "batched":
        # resolved like workload defaults: the hash must capture the timestep
        # the discretization ran at
        from repro_torch.core.batched import DEFAULT_DT_MIN

        kw = dict(backend_kwargs or {})
        kw["dt_min"] = float(kw.get("dt_min", DEFAULT_DT_MIN))
        cell["backend"] = "batched"
        cell["backend_kwargs"] = kw
    return cell


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One declarative description of any sweep cell — the single build path.

    ``CellSpec`` holds the union of the constructors' parameters once,
    validates the combinations, and :meth:`to_cell` emits the dict with the
    reference's key-presence rules, so every cell hashes as the reference's
    does.  :func:`make_cell`, :func:`make_scenario_cell` and
    :func:`make_fleet_cell` are thin wrappers.

    Job stream: exactly one of ``workload`` (a raw :class:`WorkloadSpec`)
    or ``scenario`` (a registered scenario name; ``scenario_kwargs`` are
    resolved against its defaults into the cell).  Fleet cells
    (``fleet_profiles`` set) require a scenario stream and a dispatcher;
    ``dispatch_info`` enters the cell under the ``fleet.info`` key.
    """

    experiment: str
    group: str
    scheduler: str
    seed: int
    # --- job stream (exactly one) -------------------------------------
    workload: Optional[WorkloadSpec] = None
    scenario: Optional[str] = None
    scenario_kwargs: Optional[Mapping[str, Any]] = None
    # --- policy + physics ---------------------------------------------
    policy: str = "static"
    policy_kwargs: Optional[Mapping[str, Any]] = None
    mig_enabled: bool = True
    repartition_mode: str = "partial"
    # --- execution backend --------------------------------------------
    backend: str = "oracle"
    backend_kwargs: Optional[Mapping[str, Any]] = None
    # --- fleet ----------------------------------------------------------
    fleet_profiles: Optional[Sequence[str]] = None
    dispatcher: Optional[str] = None
    dispatch_info: str = "online"

    def to_cell(self) -> Cell:
        """Build the JSON cell dict (validates field combinations)."""
        if (self.workload is None) == (self.scenario is None):
            raise ValueError(
                "CellSpec needs exactly one job stream: workload or scenario"
            )
        if self.scenario_kwargs is not None and self.scenario is None:
            raise ValueError("scenario_kwargs require a scenario stream")
        is_fleet = self.fleet_profiles is not None
        if is_fleet and not self.fleet_profiles:
            raise ValueError("fleet_profiles must name at least one device")
        if is_fleet and self.scenario is None:
            raise ValueError("fleet cells take a scenario stream, not a raw workload")
        if is_fleet and self.dispatcher is None:
            raise ValueError("fleet cells require a dispatcher")
        if not is_fleet and self.dispatcher is not None:
            raise ValueError("dispatcher only applies to fleet cells")
        if is_fleet and self.backend != "oracle":
            raise ValueError("fleet cells only run on the oracle backend")
        cell = _base_cell(
            experiment=self.experiment,
            group=self.group,
            scheduler=self.scheduler,
            seed=self.seed,
            policy=self.policy,
            policy_kwargs=self.policy_kwargs,
            mig_enabled=self.mig_enabled,
            repartition_mode=self.repartition_mode,
            backend=self.backend,
            backend_kwargs=self.backend_kwargs,
        )
        if self.workload is not None:
            cell["workload"] = workload_to_dict(self.workload)
        else:
            cell["scenario"] = {
                "name": self.scenario,
                "kwargs": resolve_scenario_kwargs(self.scenario, self.scenario_kwargs),
            }
        if is_fleet:
            cell["fleet"] = {
                "devices": [{"profile": p} for p in self.fleet_profiles],
                "dispatcher": self.dispatcher,
                "info": self.dispatch_info,
            }
        return cell


def make_cell(
    *,
    experiment: str,
    group: str,
    scheduler: str,
    seed: int,
    workload: Optional[WorkloadSpec] = None,
    scenario: Optional[str] = None,
    scenario_kwargs: Optional[Mapping[str, Any]] = None,
    policy: str = "static",
    policy_kwargs: Optional[Mapping[str, Any]] = None,
    mig_enabled: bool = True,
    repartition_mode: str = "partial",
    backend: str = "oracle",
    backend_kwargs: Optional[Mapping[str, Any]] = None,
) -> Cell:
    """A single-GPU cell, thin over :class:`CellSpec` (the one build path).

    Its job stream is a raw :class:`WorkloadSpec`, as the reference's
    ``make_cell`` takes, or a registered scenario, as
    :func:`make_scenario_cell` takes; the cell is the one the reference
    builds for either.
    """
    return CellSpec(
        experiment=experiment,
        group=group,
        scheduler=scheduler,
        seed=seed,
        workload=workload,
        scenario=scenario,
        scenario_kwargs=scenario_kwargs,
        policy=policy,
        policy_kwargs=policy_kwargs,
        mig_enabled=mig_enabled,
        repartition_mode=repartition_mode,
        backend=backend,
        backend_kwargs=backend_kwargs,
    ).to_cell()


def make_scenario_cell(
    *,
    experiment: str,
    group: str,
    scheduler: str,
    scenario: str,
    seed: int,
    scenario_kwargs: Optional[Mapping[str, Any]] = None,
    policy: str = "static",
    policy_kwargs: Optional[Mapping[str, Any]] = None,
    mig_enabled: bool = True,
    repartition_mode: str = "partial",
    backend: str = "oracle",
    backend_kwargs: Optional[Mapping[str, Any]] = None,
) -> Cell:
    """A cell whose jobs come from a registered scenario, not a raw spec.

    Thin wrapper over :class:`CellSpec`; the scenario's knobs are resolved
    against its defaults into the cell — the content hash must capture the
    values the generator saw, exactly as :func:`workload_to_dict` resolves
    :class:`WorkloadSpec` defaults.
    """
    return CellSpec(
        experiment=experiment,
        group=group,
        scheduler=scheduler,
        seed=seed,
        scenario=scenario,
        scenario_kwargs=scenario_kwargs,
        policy=policy,
        policy_kwargs=policy_kwargs,
        mig_enabled=mig_enabled,
        repartition_mode=repartition_mode,
        backend=backend,
        backend_kwargs=backend_kwargs,
    ).to_cell()


def make_fleet_cell(
    *,
    experiment: str,
    group: str,
    profiles: Sequence[str],
    dispatcher: str,
    scheduler: str,
    scenario: str,
    seed: int,
    scenario_kwargs: Optional[Mapping[str, Any]] = None,
    policy: str = "static",
    policy_kwargs: Optional[Mapping[str, Any]] = None,
    mig_enabled: bool = True,
    dispatch_info: str = "online",
    repartition_mode: str = "partial",
) -> Cell:
    """A fleet cell: N devices (by profile name) behind a dispatcher.

    Thin wrapper over :class:`CellSpec`; the extra ``fleet`` key routes
    :func:`run_cell` through :class:`repro_torch.fleet.FleetSimulator`.
    Every device runs ``scheduler`` and an independent instance of the cell's
    repartitioning policy.  ``dispatch_info`` selects what the dispatcher
    observes — ``"online"`` (real co-advanced engine state, the default) or
    ``"fluid"`` (the legacy backlog-estimate pre-split); the resolved value
    always enters the cell so the content hash captures it.
    """
    return CellSpec(
        experiment=experiment,
        group=group,
        scheduler=scheduler,
        seed=seed,
        scenario=scenario,
        scenario_kwargs=scenario_kwargs,
        policy=policy,
        policy_kwargs=policy_kwargs,
        mig_enabled=mig_enabled,
        repartition_mode=repartition_mode,
        fleet_profiles=tuple(profiles),
        dispatcher=dispatcher,
        dispatch_info=dispatch_info,
    ).to_cell()


def canonical_json(obj: Any) -> str:
    """Byte-stable JSON: sorted keys, no whitespace, repr round-trip floats."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


#: cell keys that label the grid rather than the simulation — excluded from
#: the hash so identical physics shares one cache entry across experiments.
_META_KEYS = frozenset({"experiment", "group"})


def cell_hash(cell: Cell, sim_version: str = SIM_VERSION) -> str:
    """Content hash of the cell's physics + simulator version (cache key)."""
    physics = {k: v for k, v in cell.items() if k not in _META_KEYS}
    payload = canonical_json({"cell": physics, "sim_version": sim_version})
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


# ----------------------------------------------------------------------
# execution

def cell_jobs(cell: Cell) -> List[Any]:
    """Materialize the cell's job stream (scenario cells or raw-spec cells)."""
    if "scenario" in cell:
        sc = cell["scenario"]
        return generate_scenario(sc["name"], seed=cell["seed"], **sc.get("kwargs", {}))
    spec = WorkloadSpec(**cell["workload"])
    return generate_jobs(spec, seed=cell["seed"])


def _tenants_dict(res: SimResult) -> Dict[str, Dict[str, Any]]:
    return {
        name: {
            "jobs": st.jobs,
            "attained": st.attained,
            "latency_sum_min": st.latency_sum_min,
        }
        for name, st in sorted(res.tenants.items())
    }


def _result_dict(
    res: SimResult,
    util_histogram: Mapping[int, float],
    config_trace: Sequence[Any],
    t0: float,
) -> Dict[str, Any]:
    out = {
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
        # side-channel state some figures aggregate over:
        "util_histogram": {str(k): v for k, v in util_histogram.items()},
        "config_trace": [[t, c] for t, c in config_trace],
        # lint: waive[DT002] wall telemetry; stripped before baseline compare
        "elapsed_s": time.perf_counter() - t0,
    }
    # only serving workloads emit tenant stats — batch cells keep the exact
    # historical key set
    if res.tenants:
        out["tenants"] = _tenants_dict(res)
        out["slo_attainment"] = res.slo_attainment
    return out


def _run_fleet_cell(
    cell: Cell,
    policy_factory: Optional[Callable[[], RepartitionPolicy]],
    device: torch.device,
) -> Dict[str, Any]:
    from repro_torch.fleet import FleetDeviceSpec, FleetSimulator, FleetSpec

    f = cell["fleet"]
    spec = FleetSpec(
        devices=tuple(
            FleetDeviceSpec(
                profile=d["profile"],
                scheduler=d.get("scheduler"),
                initial_config=d.get("initial_config"),
            )
            for d in f["devices"]
        ),
        dispatcher=f["dispatcher"],
        scheduler=cell["scheduler"],
        dispatch_info=f.get("info", "online"),
        repartition_mode=cell_repartition_mode(cell),
    )
    if policy_factory is not None:
        def per_device_policy(i, prof):
            return policy_factory()
    else:
        def per_device_policy(i, prof):
            # independent instance per device: policies carry run state
            return make_policy(cell["policy"], _cell_policy_kwargs(cell), device=device)

    t0 = time.perf_counter()  # lint: waive[DT002] elapsed_s telemetry only
    jobs = cell_jobs(cell)
    fsim = FleetSimulator(spec, mig_enabled=cell["mig_enabled"])
    fres = fsim.run(jobs, policy_factory=per_device_policy)

    util: Dict[int, float] = {}
    for sim in fsim.sims:
        for k, v in sim.util_histogram.items():
            util[k] = util.get(k, 0.0) + v
    out = _result_dict(fres.aggregate, util, [], t0)
    out["dispatch_counts"] = list(fres.dispatch_counts)
    devices = []
    for d, r in zip(f["devices"], fres.per_device, strict=True):
        entry = {
            "profile": d["profile"],
            "num_jobs": r.num_jobs,
            "energy_wh": r.energy_wh,
            "avg_tardiness": r.avg_tardiness,
            "repartitions": r.repartitions,
        }
        if r.tenants:  # serving cells: per-device SLO breakdown
            entry["tenants"] = _tenants_dict(r)
            entry["slo_attainment"] = r.slo_attainment
        devices.append(entry)
    out["devices"] = devices
    return out


def run_cell(
    cell: Cell,
    policy_factory: Optional[Callable[[], RepartitionPolicy]] = None,
    *,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Execute one cell; returns the reference's result dict.

    ``policy_factory`` overrides the registry lookup for in-process runs with
    ad-hoc policies (e.g. a greedy agent on a learner already in memory);
    such cells bypass the cache at the runner layer.  A cell with a ``fleet``
    key runs through :class:`repro_torch.fleet.FleetSimulator` (one policy
    instance a device) and reports the fleet aggregate in the standard
    fields, plus ``dispatch_counts`` and ``devices``.  A cell with ``backend
    == "batched"`` runs through :mod:`repro_torch.sweep.batched` (a one-cell
    batch here; :func:`repro_torch.sweep.runner.run_cells` groups them).
    ``device`` is where a registry DQN's Q network and the batched simulator
    run: ``None`` is the CUDA card and raises without one; the CPU runs only
    on ``device="cpu"``.
    """
    dev = resolve_device(device)
    if cell.get("backend") == "batched":
        if policy_factory is not None:
            raise ValueError(
                "ad-hoc policy_factory cells cannot run on the batched "
                "backend (policies must compile; see repro_torch.core.batched)"
            )
        from repro_torch.sweep.batched import run_batched_cells

        return run_batched_cells([cell], device=dev)[0]
    if "fleet" in cell:
        return _run_fleet_cell(cell, policy_factory, dev)
    jobs = cell_jobs(cell)
    if policy_factory is not None:
        policy = policy_factory()
    else:
        policy = make_policy(cell["policy"], _cell_policy_kwargs(cell), device=dev)
    sim = MIGSimulator(
        make_scheduler(cell["scheduler"]),
        mig_enabled=cell["mig_enabled"],
        repartition_mode=cell_repartition_mode(cell),
    )
    t0 = time.perf_counter()  # lint: waive[DT002] elapsed_s telemetry only
    res = sim.run(jobs, policy=policy)
    return _result_dict(res, sim.util_histogram, sim.config_trace, t0)


_RESULT_FIELDS = (
    "energy_wh",
    "avg_tardiness",
    "num_jobs",
    "total_tardiness",
    "preemptions",
    "repartitions",
    "max_tardiness",
    "deadline_misses",
    "busy_slot_minutes",
)


def result_to_sim_result(result: Mapping[str, Any]) -> SimResult:
    """Reconstruct the :class:`SimResult` a cell's simulator run returned."""
    tenants = {
        name: TenantSLOStats(**st)
        for name, st in dict(result.get("tenants") or {}).items()
    }
    return SimResult(
        **{k: result[k] for k in _RESULT_FIELDS},
        extra=dict(result["extra"]),
        tenants=tenants,
    )


def group_results(
    cells: Sequence[Cell], results: Sequence[Mapping[str, Any]]
) -> Dict[str, List[SimResult]]:
    """Bucket per-cell results by ``cell['group']``, preserving cell order.

    Order preservation matters: float summation is order-sensitive, and the
    reference's aggregates accumulate results in grid order — grouping in the
    same order keeps aggregate numbers bit-identical to the reference's.
    """
    out: Dict[str, List[SimResult]] = {}
    for cell, result in zip(cells, results, strict=True):
        out.setdefault(cell["group"], []).append(result_to_sim_result(result))
    return out
