"""The port's fleet layer (``repro_torch.fleet``, fleet cells, ``evaluate_policy_fleet``) against the JAX package's ``repro.fleet``, on the CPU.

Mirrors the reference's tests/test_fleet.py, each case held with ``==``
against the reference: the device profiles, the A30 table and the power
curves, every dispatcher's picks and ``dispatch_jobs``' trace, the 1-device
fleet bit-identical to the single path in both modes, online against fluid,
``FleetStream``'s submit, cancel and run_until (with the engine's ``cancel``
and ``job_disposition``), ``fleet_state_features``,
``device_forecast_factory`` and ``evaluate_policy_fleet`` ad hoc and with the
registry's ``"dqn"`` on ``rl_dqn_params.npz``.  All of it is float64 host
code copied with the reference's order of operations and tie-breaks; only
the DQN's Q network is torch (here on the CPU).

The checked-in fleet rows are held at the reference's baseline tolerance
(rtol 1e-9; integers, ``dispatch_counts``, per-device tenants,
``config_trace`` and ``util_histogram`` exact): all 30 paper-diurnal rows of
``fleet_scaling`` and ``dispatchers``, and the first row (the ``balanced``
mix) of each of the 8 fleet x dispatcher groups of ``serving_matrix``.
``chip_smoke.py`` replays all 54 on the card machine.

``tests/data/torch_fleet_golden.json`` holds the reference's result dicts of
``evaluate_policy_fleet`` with the checked-in npz as the registry's
``"dqn"`` on 2xA100+2xA30, state-aware, paper-diurnal, 4 days: the run of
``chip_smoke.py``'s ``fleet_dqn`` phase.  Rewrite it (where JAX is) with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fleet.py --write-golden``.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_fleet.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import warnings
from pathlib import Path

import pytest

import repro.core.power as RPW
import repro.core.slices as RS
import repro.fleet as RF
import repro.sweep.cells as RC
import repro_torch.core.power as PPW
import repro_torch.core.slices as PS
import repro_torch.fleet as PF
import repro_torch.sweep.cells as PC
from repro.core.engine import SimulationEngine as RefEngine
from repro.core.jobs import LINEAR as REF_LINEAR
from repro.core.jobs import Job as RefJob
from repro.core.jobs import JobKind as RefKind
from repro.core.rl.env import fleet_state_features as ref_fleet_features
from repro.core.schedulers import make_scheduler as ref_scheduler
from repro.core.simulator import DayNightPolicy as RefDayNight
from repro.core.simulator import MIGSimulator as RefSim
from repro.core.simulator import StaticPolicy as RefStatic
from repro.core.workload import WorkloadSpec as RefSpec
from repro.core.workload import generate_jobs as ref_jobs
from repro_torch.core.engine import SimulationEngine
from repro_torch.core.jobs import LINEAR, Job, JobKind
from repro_torch.core.rl.env import FEATURE_DIM, FLEET_FEATURE_DIM, fleet_state_features
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import DayNightPolicy, MIGSimulator, StaticPolicy
from repro_torch.core.workload import WorkloadSpec, generate_jobs
from repro_torch.launch.evaluate import _exact_part, _max_rel, values_close

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
PARAMS = str(BASELINES / "rl_dqn_params.npz")
GOLDEN = Path(__file__).resolve().parent / "data" / "torch_fleet_golden.json"
RTOL = 1e-9

# the golden run (chip_smoke.py's fleet_dqn): evaluate_policy_fleet's cells
GOLDEN_RUN = {
    "profiles": ["a100-250w", "a100-250w", "a30-165w", "a30-165w"],
    "dispatcher": "state-aware",
    "scheduler": "EDF-SS",
    "scenario": "paper-diurnal",
    "num_iterations": 4,
    "seed": 20_000,
    "params": "benchmarks/baselines/rl_dqn_params.npz",
}

DAY = dict(horizon_min=1440.0)
SHORT = dict(horizon_min=180.0, constant_rate=0.4)
HETERO = ["a100-250w", "a30-165w", "a100-250w"]
FLUID_DISPATCHERS = ("round-robin", "least-loaded", "energy-greedy")
ALL_DISPATCHERS = FLUID_DISPATCHERS + ("state-aware", "fragmentation-aware")


def _jobs(spec_kw, seed):
    """The same job stream in both packages."""
    return ref_jobs(RefSpec(**spec_kw), seed), generate_jobs(WorkloadSpec(**spec_kw), seed)


def _res(r) -> dict:
    """Every field of a SimResult (tenants included), package-neutral."""
    return dataclasses.asdict(r)


def _fleet(fr) -> dict:
    return {
        "aggregate": _res(fr.aggregate), "per_device": [_res(r) for r in fr.per_device],
        "dispatch_counts": list(fr.dispatch_counts), "trace": list(fr.trace),
    }


def _partition(p) -> tuple:
    return (p.config_id, tuple((s.slots, s.memory_gb) for s in p.slices), tuple(p.starts))


def _table(configs) -> dict:
    return {cid: _partition(p) for cid, p in configs.items()}


def _power(pm) -> tuple:
    return (pm.name, tuple(pm.watts_by_busy_slots), pm.total_slots)


# ------------------------------ devices --------------------------------------


@pytest.mark.parametrize("name", sorted(RF.DEVICE_PROFILES))
def test_device_profiles_match_reference(name):
    got, want = PF.device_profile(name), RF.device_profile(name)
    assert sorted(PF.DEVICE_PROFILES) == sorted(RF.DEVICE_PROFILES)
    assert got.name == want.name and got.default_config == want.default_config
    assert _power(got.power) == _power(want.power)
    assert _table(got.configs) == _table(want.configs)
    assert (got.total_slots, got.slice_sizes, got.config_ids()) == (
        want.total_slots, want.slice_sizes, want.config_ids())
    with pytest.raises(KeyError, match="unknown device profile"):
        PF.device_profile("h100-apocryphal")


def test_a30_table_power_curves_and_fleet_fragmentation_match_reference():
    assert _table(PS.A30_CONFIGS) == _table(RS.A30_CONFIGS)
    for name in ("A100_250W", "A30_165W", "TPU_V5E_POD"):
        assert _power(getattr(PPW, name)) == _power(getattr(RPW, name)), name
        for busy in (0.0, 0.5, 1.0, 2.25, 3.0, 3.99, 4.0, 6.5, 7.0):
            assert getattr(PPW, name).power_watts(busy) == getattr(RPW, name).power_watts(busy)
    assert {"A30_165W", "TPU_V5E_POD"} <= set(PPW.__all__)
    geos = []
    for table, ptable, total, sizes in ((RS.MIG_CONFIGS, PS.MIG_CONFIGS, 7, (1, 2, 3, 4, 7)),
                                        (RS.A30_CONFIGS, PS.A30_CONFIGS, 4, (1, 2, 4))):
        for cid in table:
            for occupied in ((), (0,), tuple(range(len(table[cid].slices)))[::2]):
                geos.append((RS.free_slot_geometry(table[cid], occupied, total_slots=total,
                                                   slice_sizes=sizes),
                             PS.free_slot_geometry(ptable[cid], occupied, total_slots=total,
                                                   slice_sizes=sizes)))
    for k in range(0, len(geos), 5):
        part = geos[k:k + 5]
        assert PS.fleet_fragmentation([g for _, g in part]) == RS.fleet_fragmentation([g for g, _ in part])
    assert PS.fleet_fragmentation([]) == RS.fleet_fragmentation([]) == 0.0
    bad = dict(PS.A30_CONFIGS)
    bad[2] = PS._mk(2, PS.A30_S4_24, PS.A30_S2_12)
    with pytest.raises(AssertionError, match="a30-test table, config 2 exceeds 4 slots"):
        PS.validate_config_table(bad, 4, 36, name="a30-test")


def test_a30_table_runs_the_simulator_as_the_reference():
    ref, port = _jobs(SHORT, 1)
    rp, pp = RF.device_profile("a30-165w"), PF.device_profile("a30-165w")
    want = RefSim(ref_scheduler("EDF-SS"), power_model=rp.power, config_table=rp.configs).run(
        ref, policy=RefStatic(rp.default_config))
    got = MIGSimulator(make_scheduler("EDF-SS"), power_model=pp.power, config_table=pp.configs).run(
        port, policy=StaticPolicy(pp.default_config))
    assert _res(got) == _res(want) and got.num_jobs == len(port)
    sim = MIGSimulator(make_scheduler("EDF-SS"), config_table=pp.configs)
    with pytest.raises(ValueError, match="StaticPolicy.*not in this device's"):
        sim.run(generate_jobs(WorkloadSpec(**SHORT), 2), policy=StaticPolicy(12))


def test_device_adapted_policy_matches_reference():
    got = PF.DeviceAdaptedPolicy(DayNightPolicy(), PS.A30_CONFIGS)
    want = RF.DeviceAdaptedPolicy(RefDayNight(), RS.A30_CONFIGS)
    for choice in (None, *range(1, 13), 99):
        assert got._map(choice) == want._map(choice)
    assert got.initial_config == want.initial_config
    assert (got._map(6), got._map(2)) == (3, 2)


# ------------------------------ dispatch -------------------------------------


@pytest.mark.parametrize("dispatcher", FLUID_DISPATCHERS)
@pytest.mark.parametrize("spec_kw, seed, n", [
    (SHORT, 3, 3), (DAY, 4, 2), (dict(horizon_min=120.0, constant_rate=0.1), 5, 3),
    (dict(horizon_min=240.0, constant_rate=2.0), 8, 3),
])
def test_dispatch_jobs_matches_reference(dispatcher, spec_kw, seed, n):
    ref, port = _jobs(spec_kw, seed)
    profiles = ["a100-250w", "a30-165w", "a100-250w"][:n]
    got = PF.dispatch_jobs(port, [PF.device_profile(p) for p in profiles], PF.make_dispatcher(dispatcher))
    want = RF.dispatch_jobs(ref, [RF.device_profile(p) for p in profiles], RF.make_dispatcher(dispatcher))
    assert got == want
    assignments, trace = got
    assert len(trace) == len(port)
    if dispatcher == "round-robin":
        assert assignments == [i % n for i in range(len(port))]


def test_energy_greedy_packs_idle_and_spills_under_overload():
    _, light = _jobs(dict(horizon_min=120.0, constant_rate=0.1), 5)
    _, heavy = _jobs(dict(horizon_min=240.0, constant_rate=2.0), 8)
    profiles = [PF.device_profile("a100-250w")] * 3
    assert len(set(PF.dispatch_jobs(light, profiles, PF.make_dispatcher("energy-greedy"))[0])) == 1
    assert len(set(PF.dispatch_jobs(heavy, profiles, PF.make_dispatcher("energy-greedy"))[0])) == 3


def test_dispatch_checks_and_registry_match_reference():
    _, port = _jobs(SHORT, 6)
    jobs = [port[1], port[0], *port[2:4]]
    with pytest.raises(ValueError, match="sorted"):
        PF.dispatch_jobs(jobs, [PF.device_profile("a100-250w")], PF.make_dispatcher("round-robin"))
    assert list(PF.DISPATCHERS) == list(RF.DISPATCHERS)
    with pytest.raises(KeyError, match="unknown dispatcher"):
        PF.make_dispatcher("clairvoyant")
    for name in ("state-aware", "fragmentation-aware"):
        with pytest.raises(ValueError, match="cannot run in fluid mode"):
            PF.dispatch_jobs(port, [PF.device_profile("a100-250w")], PF.make_dispatcher(name))
    assert PF.DISPATCH_INFO_MODES == RF.simulator.DISPATCH_INFO_MODES
    with pytest.raises(ValueError, match="unknown dispatch_info"):
        PF.FleetSimulator(PF.FleetSpec.of(["a100-250w"], dispatch_info="psychic"))
    with pytest.raises(ValueError, match="at least one device"):
        PF.FleetSimulator(PF.FleetSpec(devices=()))
    with pytest.raises(ValueError):
        PF.aggregate_sim_results([])


def test_legacy_dispatcher_adapter_warns_and_routes_as_reference():
    class Legacy:
        name = "legacy-first"

        def pick(self, job, t, states):
            return min(range(len(states)), key=lambda i: (states[i].dispatched, i))

    ref, port = _jobs(SHORT, 9)
    with pytest.warns(DeprecationWarning, match="deprecated pick"):
        wrapped = PF.as_context_dispatcher(Legacy())
    assert wrapped.name == "legacy-first" and not wrapped.requires_online
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = PF.dispatch_jobs(port, [PF.device_profile("a100-250w")] * 2, Legacy())
        want = RF.dispatch_jobs(ref, [RF.device_profile("a100-250w")] * 2, Legacy())
    assert got == want
    modern = PF.make_dispatcher("least-loaded")
    assert PF.as_context_dispatcher(modern) is modern


def test_job_demand_slots_matches_reference():
    from repro.core.jobs import capped as ref_capped
    from repro.fleet.dispatch import job_demand_slots as ref_demand
    from repro_torch.core.jobs import capped
    from repro_torch.fleet.dispatch import job_demand_slots

    for cap in (2, 3, 4):
        assert job_demand_slots(Job(0, JobKind.INFERENCE, 0.0, 1.0, 5.0, capped(cap))) == ref_demand(
            RefJob(0, RefKind.INFERENCE, 0.0, 1.0, 5.0, ref_capped(cap))) == cap
    assert job_demand_slots(Job(0, JobKind.TRAINING, 0.0, 1.0, 5.0, LINEAR)) == 1


# ---------------------------- fleet simulation -------------------------------


@pytest.mark.parametrize("info", ["online", "fluid"])
def test_one_gpu_fleet_bit_identical_to_single_path(info):
    ref, port = _jobs(DAY, 42)
    single = MIGSimulator(make_scheduler("EDF-SS")).run(port, policy=StaticPolicy(3))
    _, port2 = _jobs(DAY, 42)
    fleet = PF.FleetSimulator(PF.FleetSpec.of(["a100-250w"], dispatch_info=info)).run(
        port2, policy_factory=lambda i, p: StaticPolicy(3))
    assert _res(fleet.aggregate) == _res(single)
    want = RF.FleetSimulator(RF.FleetSpec.of(["a100-250w"], dispatch_info=info)).run(
        ref, policy_factory=lambda i, p: RefStatic(3))
    assert _fleet(fleet) == _fleet(want)


def test_one_gpu_fleet_online_bit_identical_with_timer_policy():
    _, port = _jobs(DAY, 7)
    _, port2 = _jobs(DAY, 7)
    single = MIGSimulator(make_scheduler("EDF-SS")).run(port, policy=DayNightPolicy())
    fleet = PF.FleetSimulator(PF.FleetSpec.of(["a100-250w"])).run(
        port2, policy_factory=lambda i, p: DayNightPolicy())
    assert fleet.aggregate == single and fleet.aggregate.repartitions >= 2


@pytest.mark.parametrize("dispatcher, info", [(d, "online") for d in ALL_DISPATCHERS]
                         + [(d, "fluid") for d in FLUID_DISPATCHERS])
def test_heterogeneous_fleet_day_matches_reference(dispatcher, info):
    """A loaded A100/A30/A100 fleet under DayNight (translated on the A30):
    aggregate, every device's result, the counts and the dispatch trace."""
    spec_kw = dict(horizon_min=360.0, constant_rate=0.8)
    ref, port = _jobs(spec_kw, 33)
    got = PF.FleetSimulator(PF.FleetSpec.of(HETERO, dispatcher=dispatcher, dispatch_info=info)).run(
        port, policy_factory=lambda i, p: DayNightPolicy())
    want = RF.FleetSimulator(RF.FleetSpec.of(HETERO, dispatcher=dispatcher, dispatch_info=info)).run(
        ref, policy_factory=lambda i, p: RefDayNight())
    assert _fleet(got) == _fleet(want)
    assert sum(got.dispatch_counts) == len(port) == got.aggregate.num_jobs
    assert "fleet_idle_gap_wh" in got.aggregate.extra


def test_online_dispatch_differs_from_fluid_and_observes_real_state():
    spec_kw = dict(horizon_min=360.0, constant_rate=0.8)
    runs = {}
    for info in ("online", "fluid"):
        fs = PF.FleetSimulator(PF.FleetSpec.of(["a100-250w", "a30-165w"], dispatcher="least-loaded",
                                               dispatch_info=info))
        runs[info] = fs.run(generate_jobs(WorkloadSpec(**spec_kw), 33),
                            policy_factory=lambda i, p: StaticPolicy(3))
        if info == "online":
            assert len(fs.engines) == 2
            for engine in fs.engines:
                snap = engine.snapshot()
                assert engine.finished and snap.sim.backlog_1g_min == 0.0 and snap.events_processed > 0
    assert sum(runs["online"].dispatch_counts) == sum(runs["fluid"].dispatch_counts)
    assert runs["online"].dispatch_counts != runs["fluid"].dispatch_counts


def _engines(mod_sim, mod_sched, mod_engine, static, n=2):
    out = []
    for _ in range(n):
        sim = mod_sim(mod_sched("EDF-SS"))
        out.append(mod_engine(sim, policy=static(3), stream_open=True))
    return out


def test_state_aware_avoids_repartitioning_device():
    picks, remaining = [], []
    for fleet, sim_c, sched, eng, static, job in (
        (PF, MIGSimulator, make_scheduler, SimulationEngine, StaticPolicy,
         Job(99, JobKind.INFERENCE, 0.0, 1.0, 10.0, LINEAR)),
        (RF, RefSim, ref_scheduler, RefEngine, RefStatic,
         RefJob(99, RefKind.INFERENCE, 0.0, 1.0, 10.0, REF_LINEAR)),
    ):
        engines = _engines(sim_c, sched, eng, static)
        engines[0].sim._start_repartition(6)
        prof = fleet.device_profile("a100-250w")
        states = [fleet.EngineDeviceState(i, prof, e) for i, e in enumerate(engines)]
        ctx = fleet.DispatchContext(t=0.0, job=job, devices=states)
        picks.append((fleet.StateAwareDispatcher().pick(ctx), fleet.FragmentationAwareDispatcher().pick(ctx)))
        remaining.append([(s.repartition_remaining_min, s.stalled_fraction, s.free_slices) for s in states])
    assert picks[0] == picks[1] == (1, 1)
    assert remaining[0] == remaining[1] and remaining[0][0][0] > 0.0 == remaining[0][1][0]


def test_engine_device_state_projects_to_observed_instant():
    prof = PF.device_profile("a100-250w")
    sim = MIGSimulator(make_scheduler("EDF-SS"))
    engine = SimulationEngine(sim, policy=StaticPolicy(1), stream_open=True)
    engine.inject(Job(0, JobKind.TRAINING, 0.0, 140.0, 100.0, LINEAR))
    engine.run_until(10.0, inclusive=False)
    assert sim.t == 0.0
    st = PF.EngineDeviceState(0, prof, engine)
    assert st.backlog_1g_min == pytest.approx(140.0)
    st.observe_at(10.0)
    assert st.backlog_1g_min == pytest.approx(140.0 - 7.0 * 10.0)
    st.observe_at(15.0)
    assert st.normalized_load == pytest.approx((140.0 - 7.0 * 15.0) / 7.0)
    assert sim.t == 0.0 and sim.active[0].remaining == pytest.approx(140.0)
    geo = st.free_geometry()
    assert geo is not None and geo.free_slots == 0 and st.free_slices == 0


def test_policies_are_per_device_instances():
    seen = []

    def factory(i, prof):
        seen.append(StaticPolicy(3))
        return seen[-1]

    PF.FleetSimulator(PF.FleetSpec.of(["a100-250w"] * 3)).run(
        generate_jobs(WorkloadSpec(**SHORT), 21), policy_factory=factory)
    assert len({id(p) for p in seen}) == 3


# ------------------------ streams and cancellation ---------------------------


def _stream_script(fleet, spec_c, jobs_fn, static, day_night):
    """Submit a short stream with idle ticks and cancellations in every state;
    returns what each operation returned and the closed stream's result."""
    jobs = jobs_fn(spec_c(**SHORT), 11)
    fs = fleet.FleetSimulator(fleet.FleetSpec.of(["a100-250w", "a30-165w"], dispatcher="state-aware"))
    stream = fs.open_stream(lambda i, p: day_night() if i == 0 else static(p.default_config))
    log = []
    for k, job in enumerate(jobs):
        if k % 7 == 3:
            log.append(("tick", stream.run_until(job.arrival)))
        log.append(("submit", stream.submit(job)))
        if k % 11 == 5:
            owner = stream.owner[job.job_id]
            log.append(("disposition", stream.engines[owner].job_disposition(job.job_id)))
            log.append(("cancel", stream.cancel(job.job_id)))
        if k % 13 == 8 and k > 3:
            victim = jobs[k - 3].job_id
            owner = stream.owner[victim]
            state = stream.engines[owner].job_disposition(victim)
            log.append(("disposition", state))
            if state in ("queued", "running", "pending"):
                log.append(("cancel", stream.cancel(victim)))
    for bad in (jobs[5].job_id, 10**9):
        with pytest.raises(ValueError, match="cannot cancel job"):
            stream.cancel(bad)
    with pytest.raises(RuntimeError, match="still open"):
        stream.result()
    stream.close()
    with pytest.raises(RuntimeError, match="closed"):
        stream.submit(jobs[-1])
    res = stream.result()
    log.append(("dispositions", [e.job_disposition(j.job_id) for j in jobs for e in stream.engines
                                 if j.job_id in e._jobs_by_id]))
    return log, _fleet(res)


def test_fleet_stream_submit_cancel_run_until_match_reference():
    got = _stream_script(PF, WorkloadSpec, generate_jobs, StaticPolicy, DayNightPolicy)
    want = _stream_script(RF, RefSpec, ref_jobs, RefStatic, RefDayNight)
    assert got == want
    kinds = [x for k, x in got[0] if k == "cancel"]
    assert "dequeued" in kinds or "preempted" in kinds
    assert any("cancelled_jobs" in d["extra"] for d in got[1]["per_device"])


def test_stream_fed_a_whole_list_equals_run():
    _, a = _jobs(SHORT, 12)
    _, b = _jobs(SHORT, 12)
    spec = PF.FleetSpec.of(HETERO, dispatcher="fragmentation-aware")
    batch = PF.FleetSimulator(spec).run(a, policy_factory=lambda i, p: DayNightPolicy())
    stream = PF.FleetSimulator(spec).open_stream(lambda i, p: DayNightPolicy())
    for job in b:
        stream.submit(job)
    stream.close()
    assert _fleet(stream.result()) == _fleet(batch)


@pytest.mark.parametrize("when", ["unarrived", "early", "late"])
def test_engine_cancel_matches_reference(when):
    out = []
    for sim_c, sched, eng, static, jobs_fn, spec_c in (
        (MIGSimulator, make_scheduler, SimulationEngine, StaticPolicy, generate_jobs, WorkloadSpec),
        (RefSim, ref_scheduler, RefEngine, RefStatic, ref_jobs, RefSpec),
    ):
        jobs = jobs_fn(spec_c(**SHORT), 4)
        engine = eng(sim_c(sched("EDF-SS")), jobs=jobs, policy=static(6))
        t = {"unarrived": 0.0, "early": jobs[3].arrival + 1e-3, "late": jobs[len(jobs) // 2].arrival}[when]
        engine.run_until(t)
        log = []
        for j in jobs[::5]:
            state = engine.job_disposition(j.job_id)
            log.append(state)
            if state != "completed":
                log.append(engine.cancel(j.job_id))
                log.append(engine.job_disposition(j.job_id))
        engine.drain()
        out.append((log, _res(engine.result())))
    assert out[0] == out[1]
    assert out[0][1]["extra"]["cancelled_jobs"] > 0


# --------------------------- RL and forecasting ------------------------------


def test_fleet_state_features_match_reference():
    ref, port = _jobs(SHORT, 30)
    got = PF.FleetSimulator(PF.FleetSpec.of(["a100-250w", "a30-165w"], dispatcher="least-loaded"))
    want = RF.FleetSimulator(RF.FleetSpec.of(["a100-250w", "a30-165w"], dispatcher="least-loaded"))
    got.run(port, policy_factory=lambda i, p: StaticPolicy(p.default_config))
    want.run(ref, policy_factory=lambda i, p: RefStatic(p.default_config))
    assert FLEET_FEATURE_DIM == FEATURE_DIM + 2
    for t in (0.0, 15.0, 90.0, 179.0, 400.0):
        for i in range(2):
            f = fleet_state_features(t, got.sims[i], i, got.view)
            assert f.tolist() == ref_fleet_features(t, want.sims[i], i, want.view).tolist()
            assert f.shape == (FLEET_FEATURE_DIM,) and (f >= 0.0).all() and (f <= 1.0).all()
            assert got.view.load_share(i, t) == want.view.load_share(i, t)
        assert got.view.total_load_norm(t) == want.view.total_load_norm(t)
    f0 = fleet_state_features(90.0, got.sims[0], 0, None)
    assert f0[-2] == 0.0 and f0[-1] == 0.0


def test_mid_stream_fleet_view_reads_live_engines_as_reference():
    ref, port = _jobs(SHORT, 31)
    reads = []
    for fleet, jobs, static in ((PF, port, StaticPolicy), (RF, ref, RefStatic)):
        stream = fleet.FleetSimulator(fleet.FleetSpec.of(["a100-250w", "a30-165w"],
                                                         dispatcher="state-aware")).open_stream(
            lambda i, p, static=static: static(p.default_config))
        rows = []
        for job in jobs[:25]:
            stream.submit(job)
            rows.append([stream.view.load_share(i, job.arrival + 0.25) for i in range(2)]
                        + [stream.view.total_load_norm(job.arrival + 0.25)])
        reads.append(rows)
    assert reads[0] == reads[1]


def test_device_forecast_factory_fleet_matches_reference():
    from repro.forecast import device_forecast_factory as ref_factory
    from repro_torch.forecast import device_forecast_factory

    ref, port = _jobs(dict(horizon_min=240.0), 3)
    got = PF.FleetSimulator(PF.FleetSpec.of(["a100-250w", "a30-165w"], dispatcher="least-loaded")).run(
        port, policy_factory=device_forecast_factory())
    want = RF.FleetSimulator(RF.FleetSpec.of(["a100-250w", "a30-165w"], dispatcher="least-loaded")).run(
        ref, policy_factory=ref_factory())
    assert _fleet(got) == _fleet(want)
    pol = device_forecast_factory(min_dwell_min=2.0)(1, PF.device_profile("a30-165w"))
    assert set(pol.configs) == set(PS.A30_CONFIGS) and pol.power is PPW.A30_165W


def test_evaluate_policy_fleet_ad_hoc_matches_reference():
    from repro.core.rl.train import evaluate_policy_fleet as ref_eval
    from repro_torch.core.rl.train import evaluate_policy_fleet

    kw = dict(profiles=["a100-250w", "a100-250w"], num_iterations=2, scenario="weekend-flat",
              scenario_kwargs={"horizon_min": 240.0}, seed=77)
    got = evaluate_policy_fleet(lambda: StaticPolicy(3), device="cpu", **kw)
    want = ref_eval(lambda: RefStatic(3), **kw)
    assert [_res(r) for r in got] == [_res(r) for r in want]
    assert all(r.num_jobs > 0 for r in got)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_policy_fleet("static", num_iterations=1)


def test_evaluate_policy_fleet_registry_dqn_matches_reference(tmp_path, monkeypatch):
    """The registry's "dqn" on the checked-in npz, one Q network a device."""
    from repro.core.rl.train import evaluate_policy_fleet as ref_eval
    from repro_torch.core.rl.train import evaluate_policy_fleet

    kw = dict(profiles=["a100-250w", "a30-165w"], dispatcher="fragmentation-aware", num_iterations=1,
              scenario="bursty-mmpp", scenario_kwargs={"horizon_min": 360.0}, seed=5)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "port")  # the port's sweep cache lands here
    got = evaluate_policy_fleet(("dqn", {"params_path": PARAMS}), device="cpu", **kw)
    monkeypatch.chdir(tmp_path / "ref")  # the reference's apart from it
    want = ref_eval(("dqn", {"params_path": PARAMS}), **kw)
    assert [_res(r) for r in got] == [_res(r) for r in want]
    assert got[0].repartitions > 0


# ------------------------------- sweep cells ---------------------------------

CELL_KW = dict(experiment="t", group="g", profiles=["a100-250w", "a30-165w"], dispatcher="least-loaded",
               scheduler="EDF-SS", scenario="weekend-flat", scenario_kwargs={"horizon_min": 240.0},
               seed=5, policy="static", policy_kwargs={"config_id": 3})


@pytest.mark.parametrize("overrides", [{}, {"dispatch_info": "fluid"}, {"repartition_mode": "drain"},
                                       {"policy": "daynight", "policy_kwargs": None}])
def test_fleet_cell_and_its_run_match_reference(overrides):
    kw = {**CELL_KW, **overrides}
    got, want = PC.make_fleet_cell(**kw), RC.make_fleet_cell(**kw)
    assert got == want
    assert got["scenario"]["kwargs"]["horizon_min"] == 240.0 and "rate_per_min" in got["scenario"]["kwargs"]
    out, ref = PC.run_cell(got, device="cpu"), RC.run_cell(want)
    out.pop("elapsed_s")
    ref.pop("elapsed_s")
    assert out == ref
    assert len(out["devices"]) == 2 and sum(out["dispatch_counts"]) == out["num_jobs"] > 0


def test_fleet_cell_checks_and_refusals():
    with pytest.raises(ValueError, match="at least one device"):
        PC.make_fleet_cell(**{**CELL_KW, "profiles": []})
    # no job stream at all: CellSpec's first refusal, as the reference's make_fleet_cell gives it
    with pytest.raises(ValueError, match="exactly one job stream") as got:
        PC.make_fleet_cell(**{**CELL_KW, "scenario": None, "scenario_kwargs": None})
    with pytest.raises(ValueError) as want:
        RC.make_fleet_cell(**{**CELL_KW, "scenario": None, "scenario_kwargs": None})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="require a dispatcher"):
        PC.make_fleet_cell(**{**CELL_KW, "dispatcher": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.run_cell(PC.make_fleet_cell(**CELL_KW))


def test_one_gpu_fleet_cell_matches_single_cell_results():
    single = PC.run_cell(PC.make_cell(experiment="t", group="g", scheduler="EDF-SS", workload=WorkloadSpec(),
                                      seed=31_000, policy="static", policy_kwargs={"config_id": 3}),
                         device="cpu")
    fleet = PC.run_cell(PC.make_fleet_cell(experiment="t", group="g", profiles=["a100-250w"],
                                           dispatcher="round-robin", scheduler="EDF-SS",
                                           scenario="paper-diurnal", seed=31_000, policy="static",
                                           policy_kwargs={"config_id": 3}), device="cpu")
    for k in ("energy_wh", "avg_tardiness", "num_jobs", "total_tardiness", "preemptions", "repartitions",
              "max_tardiness", "deadline_misses", "busy_slot_minutes", "extra", "util_histogram"):
        assert fleet[k] == single[k], k


# ------------------------- checked-in fleet rows -----------------------------


def _fleet_rows():
    out = []
    for name in ("fleet_scaling", "dispatchers"):
        for line in (BASELINES / f"{name}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            out.append(pytest.param(rec, id=f"{name}:{rec['cell']['group']}:{rec['cell']['seed']}"))
    seen = set()
    for line in (BASELINES / "serving_matrix.jsonl").read_text().splitlines():
        rec = json.loads(line)
        fleet, _mix, dispatcher = rec["cell"]["group"].split(":")
        if (fleet, dispatcher) in seen:
            continue
        seen.add((fleet, dispatcher))
        out.append(pytest.param(rec, id=f"serving_matrix:{rec['cell']['group']}:{rec['cell']['seed']}"))
    return out


@pytest.mark.parametrize("rec", _fleet_rows())
def test_checked_in_fleet_row_replays(rec):
    got = PC.run_cell(rec["cell"], device="cpu")
    got.pop("elapsed_s")
    want = rec["result"]
    assert values_close(got, want, RTOL) and _exact_part(got) == _exact_part(want)
    assert got["dispatch_counts"] == want["dispatch_counts"]
    assert [d.get("tenants") for d in got["devices"]] == [d.get("tenants") for d in want["devices"]]
    assert _max_rel(got, want) <= RTOL


def test_fleet_rows_cover_the_files():
    ids = [p.id for p in _fleet_rows()]
    assert sum(i.startswith("fleet_scaling") for i in ids) == 16
    assert sum(i.startswith("dispatchers") for i in ids) == 14
    assert sum(i.startswith("serving_matrix") for i in ids) == 8


# ------------------------------- golden file ---------------------------------


def golden_cells(make, params_path: str):
    """evaluate_policy_fleet's cells for GOLDEN_RUN, built by ``make``."""
    g = GOLDEN_RUN
    return [
        make(experiment="evaluate_policy_fleet", group="dqn", profiles=g["profiles"],
             dispatcher=g["dispatcher"], scheduler=g["scheduler"], scenario=g["scenario"],
             seed=g["seed"] + it, policy="dqn", policy_kwargs={"params_path": params_path})
        for it in range(g["num_iterations"])
    ]


def _reference_golden() -> dict:
    results = []
    for cell in golden_cells(RC.make_fleet_cell, str(ROOT / GOLDEN_RUN["params"])):
        result = RC.run_cell(cell)
        result.pop("elapsed_s")
        results.append(result)
    return {"run": GOLDEN_RUN, "results": results}


def test_golden_file_is_the_reference_run():
    assert json.loads(GOLDEN.read_text()) == json.loads(json.dumps(_reference_golden()))


def test_port_fleet_dqn_day_matches_golden_file(tmp_path, monkeypatch):
    from repro_torch.core.rl.train import evaluate_policy_fleet
    from repro_torch.sweep.cells import result_to_sim_result

    golden = json.loads(GOLDEN.read_text())
    g = golden["run"]
    cells = golden_cells(PC.make_fleet_cell, str(ROOT / g["params"]))
    for cell, want in zip(cells, golden["results"], strict=True):
        got = PC.run_cell(cell, device="cpu")
        got.pop("elapsed_s")
        assert values_close(got, want, RTOL) and _exact_part(got) == _exact_part(want)
        assert got["dispatch_counts"] == want["dispatch_counts"]
    monkeypatch.chdir(tmp_path)  # evaluate_policy_fleet's sweep cache lands here
    results = evaluate_policy_fleet(("dqn", {"params_path": str(ROOT / g["params"])}), profiles=g["profiles"],
                                    dispatcher=g["dispatcher"], num_iterations=g["num_iterations"],
                                    scheduler_name=g["scheduler"], scenario=g["scenario"], seed=g["seed"],
                                    device="cpu")
    assert [_res(r) for r in results] == [_res(result_to_sim_result(w)) for w in golden["results"]]


def _write_golden() -> None:
    GOLDEN.write_text(json.dumps(_reference_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fleet.py --write-golden")
    _write_golden()
