"""The port's TPU-pod cluster day (``repro_torch.cluster``, ``launch.cluster_sim``, ``distributed.fault_tolerance``) against the JAX package's, on the CPU.

Mirrors the reference's tests/test_cluster_fault.py, each case held against
the reference: the roofline elasticities of all 40 (arch x shape) cells
(class, label, the curve and ``service_minutes`` at slot counts in and out of
range), the shapes table and its helpers, the simulated pod's per-chip
rates, the cluster workload for 3 seeds (every field of every job),
``FailureModel``'s sampling, ``HeartbeatMonitor`` and ``StragglerDetector``,
and ``run_days``: one day per policy with and without failures, and a greedy
DQN day from ``benchmarks/baselines/rl_dqn_params.npz`` with its Q network on
the CPU, each with ``==`` on every :class:`SimResult`.  The reference's two
``slow`` cases stay ``slow``.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_cluster.py``.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

import repro.analysis.constants as RCONST
import repro.cluster.elasticity as RE
import repro.cluster.workload as RW
import repro.distributed.fault_tolerance as RFT
import repro.launch.cluster_sim as RCS
import repro.launch.shapes as RSH
import repro_torch.cluster.elasticity as PE
import repro_torch.cluster.pod as POD
import repro_torch.cluster.workload as PW
import repro_torch.distributed.fault_tolerance as PFT
import repro_torch.launch.cluster_sim as PCS
import repro_torch.launch.shapes as PSH
from repro.core.metrics import et_table as ref_et_table
from repro.core.simulator import DayNightPolicy as RefDayNight
from repro.core.simulator import StaticPolicy as RefStatic
from repro_torch.core.jobs import ElasticityClass
from repro_torch.core.metrics import et_table
from repro_torch.core.simulator import StaticPolicy

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_service_golden as G  # noqa: E402

PARAMS = str(G.RL_PARAMS)
CELLS = [(arch, shape.name) for arch, shape in RSH.all_cells()]
SLOTS = (1e-7, 0.5, 1, 1.5, 2, 3, 3.5, 4, 5, 6, 7, 8)


def _res(results) -> list:
    return [dataclasses.asdict(r) for r in results]


def _ref_dqn_factory():
    from repro.core.rl import DQNConfig, DQNLearner, greedy_policy
    from repro.core.rl.env import FEATURE_DIM

    learner = DQNLearner(DQNConfig(state_dim=FEATURE_DIM))
    learner.load(PARAMS)
    return greedy_policy(learner)


# ------------------------------ elasticity ------------------------------------


def test_cells_shapes_and_pod_rates_match_reference():
    assert len(CELLS) == 40
    assert [(a, s.name) for a, s in PSH.all_cells()] == CELLS
    assert {k: dataclasses.asdict(v) for k, v in PSH.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RSH.SHAPES.items()}
    assert PSH.LONG_CAPABLE == RSH.LONG_CAPABLE and PSH.SKIP_REASONS == RSH.SKIP_REASONS
    for arch, shape in CELLS:
        assert PSH.cell_applicable(arch, shape) == RSH.cell_applicable(arch, shape)
        for dp in (1, 2, 4, 8, 16):
            assert PSH.accum_steps_for(arch, PSH.SHAPES[shape], dp) == RSH.accum_steps_for(
                arch, RSH.SHAPES[shape], dp)
    for name in ("CHIP_FLOPS_BF16", "HBM_BW", "LINK_BW"):
        assert getattr(POD, name) == getattr(RCONST, name)
    assert (PE.CHIPS_PER_SLOT, PE.COLL_ALPHA, PE._JOB_QUANTA) == (
        RE.CHIPS_PER_SLOT, RE.COLL_ALPHA, RE._JOB_QUANTA)


@pytest.mark.parametrize("arch, shape", CELLS, ids=[f"{a}:{s}" for a, s in CELLS])
def test_arch_elasticity_matches_reference(arch, shape):
    got, want = PE.arch_elasticity(arch, shape), RE.arch_elasticity(arch, shape)
    assert (got.klass.value, got.label, got.cap) == (want.klass.value, want.label, want.cap)
    assert [got.throughput(k) for k in SLOTS] == [want.throughput(k) for k in SLOTS]
    assert [PE.service_minutes(arch, shape, k) for k in SLOTS] == [
        RE.service_minutes(arch, shape, k) for k in SLOTS]
    assert PE._dryrun_record(arch, shape) is None  # no artifacts: the analytic terms
    assert PE._terms(arch, shape) == RE._terms(arch, shape) == PE._analytic_terms(arch, shape)
    assert PE._max_parallel_slots(arch, shape) == RE._max_parallel_slots(arch, shape)
    assert PE.classify_elasticity(got.throughput) == got.klass


def test_elasticity_curves_are_valid():
    for arch, shape in [("gemma3-1b", "decode_32k"), ("nemotron-4-340b", "train_4k"),
                        ("mixtral-8x7b", "decode_32k"), ("xlstm-350m", "long_500k")]:
        e = PE.arch_elasticity(arch, shape)
        assert e.throughput(1) == pytest.approx(1.0, rel=1e-6)
        prev = 0.0
        for k in range(1, 8):
            tp = e.throughput(k)
            assert prev - 1e-9 <= tp <= k + 1e-9
            prev = tp


def test_elasticity_classes_emerge_from_roofline():
    assert PE.arch_elasticity("xlstm-350m", "long_500k").klass == ElasticityClass.CAPPED
    classes = {PE.arch_elasticity(a, s).klass for a, s in [
        ("nemotron-4-340b", "train_4k"), ("gemma3-12b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
        ("xlstm-350m", "long_500k"), ("whisper-base", "decode_32k")]}
    assert len(classes) >= 2, classes


def test_service_minutes_monotone_in_slots():
    for arch, shape in [("gemma3-12b", "train_4k"), ("mixtral-8x7b", "decode_32k")]:
        ts = [PE.service_minutes(arch, shape, k) for k in range(1, 8)]
        assert all(b <= a + 1e-9 for a, b in zip(ts, ts[1:]))


def test_roofline_elasticity_refuses_pickling_as_reference():
    import pickle

    got, want = PE.arch_elasticity("gemma3-1b", "decode_32k"), RE.arch_elasticity("gemma3-1b", "decode_32k")
    with pytest.raises(ValueError, match="unknown elasticity label") as e1:
        pickle.dumps(got)
    with pytest.raises(ValueError) as e2:
        pickle.dumps(want)
    assert str(e1.value) == str(e2.value)


# ------------------------------ workload --------------------------------------


def _fields(jobs) -> list:
    return [(j.job_id, j.kind.value, j.arrival, j.work, j.deadline, j.elasticity.label,
             j.elasticity.klass.value, j.speedup_no_mig, j.tenant, j.slo_min) for j in jobs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_cluster_jobs_matches_reference(seed):
    got = PW.generate_cluster_jobs(PW.ClusterWorkloadSpec(), seed)
    want = RW.generate_cluster_jobs(RW.ClusterWorkloadSpec(), seed)
    assert _fields(got) == _fields(want) and len(got) > 400
    for j in got:
        assert j.work > 0 and j.deadline > j.arrival


def test_cluster_workload_spec_and_short_horizon_match_reference():
    spec, ref = PW.ClusterWorkloadSpec(horizon_min=240.0), RW.ClusterWorkloadSpec(horizon_min=240.0)
    assert [(a, s, w, k.value) for a, s, w, k in PW.DEFAULT_MIX] == [
        (a, s, w, k.value) for a, s, w, k in RW.DEFAULT_MIX]
    assert dataclasses.asdict(spec.as_core_spec()) == dataclasses.asdict(ref.as_core_spec())
    got = PW.generate_cluster_jobs(PW.ClusterWorkloadSpec(horizon_min=240.0, work_scale=0.5,
                                                          constant_rate=0.3), seed=7)
    want = RW.generate_cluster_jobs(RW.ClusterWorkloadSpec(horizon_min=240.0, work_scale=0.5,
                                                           constant_rate=0.3), seed=7)
    assert _fields(got) == _fields(want) and len(got) > 10


# ------------------------------ fault tolerance -------------------------------


@pytest.mark.parametrize("kw, slices, horizon", [
    (dict(mtbf_minutes=100.0, repair_minutes=10.0, seed=0), 7, 1000.0),
    (dict(mtbf_minutes=8 * 60.0, seed=3), 7, 1440.0),
    (dict(mtbf_minutes=2 * 24 * 60.0), 7, 1440.0),
])
def test_failure_model_sampling_matches_reference(kw, slices, horizon):
    got = PFT.FailureModel(**kw).sample_failures(slices, horizon)
    assert got == RFT.FailureModel(**kw).sample_failures(slices, horizon)
    assert got == sorted(got)
    fm = PFT.FailureModel(**kw)
    assert all(0 <= t < horizon and r == t + fm.repair_minutes for t, _, r in got)
    assert [fm.lost_work(x) for x in (0.0, 3.0, 25.0)] == [
        RFT.FailureModel(**kw).lost_work(x) for x in (0.0, 3.0, 25.0)]
    if kw["mtbf_minutes"] == 100.0:
        assert len(got) > 10


def test_heartbeat_monitor_matches_reference():
    out = []
    for ft in (RFT, PFT):
        hb = ft.HeartbeatMonitor(interval_min=1.0, misses_to_fail=3)
        hb.beat(0, t=0.0)
        hb.beat(1, t=0.0)
        seq = [hb.check(2.0)]
        hb.beat(1, t=2.0)
        seq += [hb.check(3.5), hb.check(3.6)]
        hb.beat(0, t=4.0)
        seq.append(sorted(hb.failed))
        out.append(seq)
    assert out[1] == out[0] == [[], [0], [], []]


def test_straggler_detector_matches_reference():
    out = []
    for ft in (RFT, PFT):
        sd = ft.StragglerDetector(straggler_factor=0.7, alpha=1.0)
        seq = [sd.observe(0, observed_rate=1.0, nominal_rate=1.0),
               sd.observe(0, observed_rate=0.5, nominal_rate=1.0)]
        sd.reset(0)
        seq.append(sd.observe(0, observed_rate=1.0, nominal_rate=1.0))
        sd2 = ft.StragglerDetector()
        seq += [sd2.observe(1, r, 1.0) for r in (0.9, 0.6, 0.5, 0.4, 0.95)]
        seq.append(dict(sd2.rate_ewma))
        out.append(seq)
    assert out[1] == out[0]
    assert out[1][:3] == [False, True, False]


# ------------------------------ the pod's days --------------------------------


REF_FACTORIES = {"static": lambda: RefStatic(3), "daynight": RefDayNight,
                 "heuristic": RCS.queue_heuristic_policy}


@pytest.mark.parametrize("failures", [False, True], ids=["no-failures", "failures"])
@pytest.mark.parametrize("policy", ["static", "daynight", "heuristic"])
def test_run_days_matches_reference(policy, failures):
    kw = dict(mtbf_minutes=8 * 60.0, seed=3)
    got = PCS.run_days(PCS.day_policy_factory(policy), iterations=1, seed=G.CLUSTER_SEED,
                       failures=PFT.FailureModel(**kw) if failures else None)
    want = RCS.run_days(REF_FACTORIES[policy], iterations=1, seed=G.CLUSTER_SEED,
                        failures=RFT.FailureModel(**kw) if failures else None)
    assert _res(got) == _res(want)
    assert got[0].num_jobs > 400
    assert PCS.POD_REPARTITION_MIN == RCS.POD_REPARTITION_MIN


@pytest.mark.parametrize("failures", [False, True], ids=["no-failures", "failures"])
def test_dqn_pod_day_on_cpu_matches_reference(failures):
    kw = dict(mtbf_minutes=8 * 60.0, seed=3)
    got = PCS.run_days(PCS.day_policy_factory("dynamic", PARAMS, "cpu"), iterations=1,
                       seed=G.CLUSTER_SEED, failures=PFT.FailureModel(**kw) if failures else None)
    want = RCS.run_days(_ref_dqn_factory, iterations=1, seed=G.CLUSTER_SEED,
                        failures=RFT.FailureModel(**kw) if failures else None)
    assert _res(got) == _res(want)
    assert got[0].repartitions > 50


def test_failure_aware_policy_matches_reference_step_by_step():
    """The wrapper's own counters (recoveries, lost work) and its timers."""
    from repro.core.power import TPU_V5E_POD as REF_POD
    from repro.core.schedulers import make_scheduler as ref_scheduler
    from repro.core.simulator import MIGSimulator as RefSim
    from repro_torch.core.power import TPU_V5E_POD
    from repro_torch.core.schedulers import make_scheduler
    from repro_torch.core.simulator import MIGSimulator

    kw = dict(mtbf_minutes=6 * 60.0, seed=1)
    out = []
    for cs, ft, sim_cls, sched, pod, wl in ((RCS, RFT, RefSim, ref_scheduler, REF_POD, RW),
                                            (PCS, PFT, MIGSimulator, make_scheduler, TPU_V5E_POD, PW)):
        fm = ft.FailureModel(**kw)
        events = fm.sample_failures(7, 24 * 60.0)
        policy = cs.FailureAwarePolicy(cs.queue_heuristic_policy(), events, fm)
        sim = sim_cls(sched("EDF-SS"), power_model=pod, repartition_penalty_min=cs.POD_REPARTITION_MIN)
        res = sim.run(wl.generate_cluster_jobs(wl.ClusterWorkloadSpec(), seed=11), policy=policy)
        timers = [policy.next_timer(t) for t in (0.0, 100.0, 700.0, 1439.0)]
        out.append((dataclasses.asdict(res), policy.recoveries, policy.lost_work_min, timers,
                    list(sim.config_trace), policy.DEGRADED_CONFIG))
    assert out[1] == out[0]
    assert out[1][1] > 0


def test_main_prints_the_reference_line(capsys, monkeypatch):
    argv = ["--policy", "heuristic", "--iterations", "1", "--failures", "--seed", "2"]
    PCS.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["cluster_sim", *argv])
    RCS.main()
    assert got == capsys.readouterr().out and got.startswith("policy=heuristic days=1 ")


def test_main_dynamic_on_cpu_prints_the_reference_line(capsys, monkeypatch):
    argv = ["--policy", "dynamic", "--iterations", "1", "--dqn-params", PARAMS, "--seed", "4"]
    PCS.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["cluster_sim", *argv])
    RCS.main()
    assert got == capsys.readouterr().out and got.startswith("policy=dynamic days=1 ")


def test_dynamic_policy_without_a_card_raises_unless_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCS.day_policy_factory("dynamic", PARAMS)
    with pytest.raises(ValueError, match="unknown policy"):
        PCS.day_policy_factory("oracle")


@pytest.mark.slow
def test_dynamic_beats_static_on_cluster_as_reference():
    per = {"static": PCS.run_days(lambda: StaticPolicy(3), iterations=3),
           "dyn": PCS.run_days(PCS.queue_heuristic_policy, iterations=3)}
    ref = {"static": RCS.run_days(lambda: RefStatic(3), iterations=3),
           "dyn": RCS.run_days(RCS.queue_heuristic_policy, iterations=3)}
    table, _ = et_table(per)
    assert {k: _res(v) for k, v in per.items()} == {k: _res(v) for k, v in ref.items()}
    assert table == ref_et_table(ref)[0]
    assert table["dyn"] < table["static"]


@pytest.mark.slow
def test_failure_injection_degrades_but_completes_as_reference():
    fm = PFT.FailureModel(mtbf_minutes=8 * 60.0, seed=3)
    ok = PCS.run_days(PCS.queue_heuristic_policy, iterations=2, seed=5)
    bad = PCS.run_days(PCS.queue_heuristic_policy, iterations=2, failures=fm, seed=5)
    assert _res(bad) == _res(RCS.run_days(RCS.queue_heuristic_policy, iterations=2,
                                          failures=RFT.FailureModel(mtbf_minutes=8 * 60.0, seed=3),
                                          seed=5))
    assert all(r.num_jobs > 0 for r in bad)
    assert sum(r.avg_tardiness for r in bad) >= sum(r.avg_tardiness for r in ok) - 1e-6


def test_example_cluster_day_table_matches_reference():
    """examples/cluster_day.py's days (2 a policy here) and its failure run
    (MTBF 12 h, seed 7): every result and the ET table equal the reference's."""
    from repro_torch.core.simulator import DayNightPolicy

    per = {"static": PCS.run_days(lambda: StaticPolicy(3), iterations=2),
           "daynight": PCS.run_days(DayNightPolicy, iterations=2),
           "dynamic": PCS.run_days(PCS.queue_heuristic_policy, iterations=2)}
    ref = {"static": RCS.run_days(lambda: RefStatic(3), iterations=2),
           "daynight": RCS.run_days(RefDayNight, iterations=2),
           "dynamic": RCS.run_days(RCS.queue_heuristic_policy, iterations=2)}
    assert {k: _res(v) for k, v in per.items()} == {k: _res(v) for k, v in ref.items()}
    assert et_table(per) == ref_et_table(ref)
    got = PCS.run_days(PCS.queue_heuristic_policy, iterations=2,
                       failures=PFT.FailureModel(mtbf_minutes=12 * 60.0, seed=7))
    want = RCS.run_days(RCS.queue_heuristic_policy, iterations=2,
                        failures=RFT.FailureModel(mtbf_minutes=12 * 60.0, seed=7))
    assert _res(got) == _res(want) and all(r.num_jobs > 0 for r in got)
