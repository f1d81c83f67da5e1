"""Sweep cells and the policy registry: one event-driven simulator run per cell.

A *cell* is one simulator run, described entirely by JSON-serializable data:

``{experiment, group, scheduler, policy, policy_kwargs, workload | scenario,
seed, mig_enabled, repartition_mode[, fleet]}``

* ``experiment`` names the grid and ``group`` the aggregation bucket inside it;
* ``policy`` + ``policy_kwargs`` name a registered repartitioning policy
  (:data:`POLICIES`);
* ``workload`` is the fully-resolved :class:`WorkloadSpec` field dict, or
  ``scenario`` a registered scenario with its resolved kwargs;
* ``seed`` drives the job stream, making the cell deterministic;
* ``fleet`` (fleet cells only) lists the devices by profile name, the
  dispatcher and what it observes (``info``).

The port's own slim copy of ``repro.sweep.cells``: the registry,
:func:`make_cell`, :func:`make_scenario_cell` and :func:`make_fleet_cell`,
and :func:`run_cell` on the oracle (the event-driven :class:`MIGSimulator`,
or :class:`repro_torch.fleet.FleetSimulator` for a cell with a ``fleet``
key), returning the reference's result dict.  The sweep engine around it
(content hashes, the on-disk cache, worker pools, the grids) is not copied:
the port runs cells inline.  ``backend == "batched"`` cells are refused (the
batched sweep route is not ported).
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.metrics import SimResult, TenantSLOStats
from repro_torch.core.scenarios import generate_scenario, resolve_scenario_kwargs
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import (
    REPARTITION_MODES,
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
    "cell_jobs",
    "cell_repartition_mode",
    "make_cell",
    "make_fleet_cell",
    "make_policy",
    "make_scenario_cell",
    "result_to_sim_result",
    "run_cell",
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
# cell construction

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
) -> Cell:
    """A single-GPU oracle cell, as the reference's ``CellSpec.to_cell`` builds it.

    Exactly one job stream: a raw :class:`WorkloadSpec` (resolved to its
    field dict) or a registered scenario (its kwargs resolved against the
    scenario's defaults).  The reference's cache-only ``_params_digest`` is
    not added.
    """
    if (workload is None) == (scenario is None):
        raise ValueError("a cell needs exactly one job stream: workload or scenario")
    if scenario_kwargs is not None and scenario is None:
        raise ValueError("scenario_kwargs require a scenario stream")
    if repartition_mode not in REPARTITION_MODES:
        raise ValueError(
            f"unknown repartition_mode {repartition_mode!r}; "
            f"valid: {REPARTITION_MODES}"
        )
    cell: Cell = {
        "experiment": experiment,
        "group": group,
        "scheduler": scheduler,
        "policy": policy,
        "policy_kwargs": dict(policy_kwargs or {}),
        "seed": int(seed),
        "mig_enabled": bool(mig_enabled),
        "repartition_mode": repartition_mode,
    }
    if workload is not None:
        cell["workload"] = dataclasses.asdict(workload)
    else:
        cell["scenario"] = {
            "name": scenario,
            "kwargs": resolve_scenario_kwargs(scenario, scenario_kwargs),
        }
    return cell


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
) -> Cell:
    """A cell whose jobs come from a registered scenario, not a raw spec
    (``multi-tenant-serving``'s cells among them); the scenario's knobs are
    resolved against its defaults into the cell. The reference's ``backend``
    arguments are not taken: the port runs cells on the oracle only."""
    return make_cell(
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
    )


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

    The extra ``fleet`` key routes :func:`run_cell` through
    :class:`repro_torch.fleet.FleetSimulator`.  Every device runs
    ``scheduler`` and an independent instance of the cell's repartitioning
    policy.  ``dispatch_info`` selects what the dispatcher observes —
    ``"online"`` (real co-advanced engine state, the default) or ``"fluid"``
    (the legacy backlog-estimate pre-split); the value always enters the
    cell, as the reference's ``CellSpec`` writes it.
    """
    profiles = tuple(profiles)
    if not profiles:
        raise ValueError("fleet_profiles must name at least one device")
    if scenario is None:
        raise ValueError("fleet cells take a scenario stream, not a raw workload")
    if dispatcher is None:
        raise ValueError("fleet cells require a dispatcher")
    cell = make_cell(
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
    )
    cell["fleet"] = {
        "devices": [{"profile": p} for p in profiles],
        "dispatcher": dispatcher,
        "info": dispatch_info,
    }
    return cell


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
        "elapsed_s": time.perf_counter() - t0,  # wall telemetry, never compared
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

    t0 = time.perf_counter()
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
    """Execute one cell on the oracle; returns the reference's result dict.

    ``policy_factory`` overrides the registry lookup (e.g. a greedy agent on
    a learner already in memory).  A cell with a ``fleet`` key runs through
    :class:`repro_torch.fleet.FleetSimulator` (one policy instance a device)
    and reports the fleet aggregate in the standard fields, plus
    ``dispatch_counts`` and ``devices``.  ``device`` is where a registry DQN's Q
    network runs: ``None`` is the CUDA card and raises without one; the CPU
    runs only on ``device="cpu"``.
    """
    dev = resolve_device(device)
    if cell.get("backend") == "batched":
        raise NotImplementedError(
            "batched-backend cells run through the batched sweep route, which "
            "the port does not have yet; run the cell without 'backend' (the "
            "oracle) or use repro_torch.core.batched.simulate_batch directly"
        )
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
    t0 = time.perf_counter()
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
