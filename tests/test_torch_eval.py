"""The port's evaluation path (``repro_torch`` engine, simulator, schedulers, policies, evaluator) against the JAX package's, on the CPU.

Everything on this path but the greedy DQN's Q network is float64 host code
copied from the reference, so the bar is ``==``: the same jobs, scheduler
and policy give the same ``SimResult`` (every field), ``config_trace`` and
``util_histogram`` in both packages.  The checked-in sweep rows, written
elsewhere, are held at the reference's own baseline tolerance (rtol 1e-9,
integers and traces exact).  ``chip_smoke.py`` replays all 464 of them on
the card machine; here one seed per group.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_eval.py``.
Rewrite the forecaster's golden coefficients (where JAX is):
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_eval.py --write-golden``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.metrics as RM
import repro.core.slices as RS
import repro.sweep.cells as RC
import repro.sweep.grids as RG
import repro_torch.core.metrics as PM
import repro_torch.core.slices as PS
import repro_torch.sweep.cells as PC
from repro.core.engine import SimulationEngine as RefEngine
from repro.core.rl.agent import NStepAccumulator as RefNStep
from repro.core.rl.env import RepartitionEnv as RefEnv
from repro.core.scenarios import generate_scenario as ref_scenario
from repro.core.schedulers import make_scheduler as ref_scheduler
from repro.core.simulator import MIGSimulator as RefSim
from repro.forecast import fit_scenario_forecaster as ref_fit
from repro.sweep.__main__ import _values_close
from repro_torch.core.engine import SimulationEngine
from repro_torch.core.rl.agent import NStepAccumulator
from repro_torch.core.rl.env import RepartitionEnv
from repro_torch.core.scenarios import generate_scenario
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import MIGSimulator
from repro_torch.forecast import fit_scenario_forecaster
from repro_torch.launch import evaluate as PE

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
PARAMS = str(BASELINES / "rl_dqn_params.npz")
GOLDEN = Path(__file__).resolve().parent / "data" / "torch_eval_forecast_golden.json"

SCHEDULERS = ("EDF-FS", "EDF-SS", "LLF", "LALF")
# the registry's six policy kinds, as the sweep grids and Table III run them
POLICIES = {
    "static": {"policy": "static", "policy_kwargs": {"config_id": 3}},
    "nomig": {"policy": "nomig", "mig_enabled": False},
    "daynight": {"policy": "daynight"},
    "heuristic": {"policy": "heuristic"},
    "forecast": {"policy": "forecast", "policy_kwargs": {"scenario": "paper-diurnal"}},
    "dqn": {"policy": "dqn", "policy_kwargs": {"params_path": PARAMS}},
}


def _ref_cell(**kw):
    """The reference's own cell for the same run (its ``make_scenario_cell``, its digest)."""
    return RC.make_scenario_cell(experiment="t", group="t", **kw)


def _both(kw):
    """Run one cell in both packages; the result dicts without the wall clock."""
    got = PC.run_cell(PC.make_cell(experiment="t", group="t", **kw), device="cpu")
    want = RC.run_cell(_ref_cell(**kw))
    got.pop("elapsed_s")
    want.pop("elapsed_s")
    return got, want


# ------------------------------ host copies ---------------------------------


@pytest.mark.parametrize("cid", sorted(RS.MIG_CONFIGS))
def test_slices_free_slot_geometry_matches_reference(cid):
    pp, rp = PS.config(cid), RS.config(cid)
    assert pp.slice_instances() == rp.slice_instances()
    assert (pp.total_slots, pp.total_memory_gb, pp.fastest_slice_index(), pp.slowest_slice_index()) == (
        rp.total_slots, rp.total_memory_gb, rp.fastest_slice_index(), rp.slowest_slice_index())
    n = pp.num_slices
    for mask in range(1 << n):
        occ = [i for i in range(n) if mask >> i & 1]
        a = PS.free_slot_geometry(pp, occ, total_slots=7)
        b = RS.free_slot_geometry(rp, occ, total_slots=7)
        assert (a.runs, a.free_slots, a.max_placeable_slots, a.fragmentation) == (
            b.runs, b.free_slots, b.max_placeable_slots, b.fragmentation)
        for slots in PS.ALL_SLICE_SIZES:
            assert a.placeable_starts(slots) == b.placeable_starts(slots)


def test_slices_tables_and_validation_match_reference():
    assert PS.config_ids() == RS.config_ids() == tuple(range(1, 13))
    assert PS.table_slice_sizes(PS.MIG_CONFIGS) == RS.table_slice_sizes(RS.MIG_CONFIGS)
    with pytest.raises(IndexError):
        PS.free_slot_geometry(PS.config(2), [2], total_slots=7)
    bad = {1: PS.Partition(1, (PS.S4_20, PS.S4_20))}  # 8 slots on a 7-slot grid
    ref_bad = {1: RS.Partition(1, (RS.S4_20, RS.S4_20))}
    msgs = []
    for validate, table in ((PS.validate_config_table, bad), (RS.validate_config_table, ref_bad)):
        with pytest.raises(AssertionError) as e:
            validate(table, 7, 40, name="x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    groups = {}
    for name in ("a", "b", "c"):
        groups[name] = [dict(energy_wh=float(rng.uniform(3e3, 6e3)),
                             avg_tardiness=float(rng.exponential(2.0)),
                             preemptions=int(rng.integers(0, 900)),
                             repartitions=int(rng.integers(0, 50)),
                             deadline_misses=int(rng.integers(0, 300)))
                        for _ in range(int(rng.integers(1, 6)))]
    port = {k: [PM.SimResult(**r) for r in v] for k, v in groups.items()}
    ref = {k: [RM.SimResult(**r) for r in v] for k, v in groups.items()}
    assert PM.et_table(port) == RM.et_table(ref)
    assert PM.et_scale_factor(port["a"]) == RM.et_scale_factor(ref["a"])
    assert PM.et_metric(port["b"], 3e-4) == RM.et_metric(ref["b"], 3e-4)
    for k in groups:
        assert PM.summarize_results(port[k]) == RG.summarize_results(ref[k])
    parts = [{"t0": (3, 2, 7.25), "t1": (1, 1, 0.5)}, {"t0": (4, 1, 9.0)}]
    pm = PM.merge_tenant_stats([{n: PM.TenantSLOStats(*v) for n, v in p.items()} for p in parts])
    rm = RM.merge_tenant_stats([{n: RM.TenantSLOStats(*v) for n, v in p.items()} for p in parts])
    assert {n: dataclasses.astuple(s) for n, s in pm.items()} == {
        n: dataclasses.astuple(s) for n, s in rm.items()}
    assert PM.slo_attainment(pm) == RM.slo_attainment(rm)
    assert PM.SimResult(1.0, 2.0).tenants == {} and PM.SimResult(1.0, 2.0).slo_attainment == 1.0


def _job_tuple(j):
    return (j.job_id, j.kind.value, j.arrival, j.work, j.deadline, j.elasticity.label,
            j.speedup_no_mig, j.remaining, j.tenant, j.slo_min)


@pytest.mark.parametrize("seed, load", [(0, 2.0), (3, 0.7), (11, 1.0)])
def test_trace_scaled_matches_reference(seed, load):
    got = generate_scenario("trace-scaled", seed=seed, load_scale=load)
    want = ref_scenario("trace-scaled", seed=seed, load_scale=load)
    assert [_job_tuple(j) for j in got] == [_job_tuple(j) for j in want]


@pytest.mark.parametrize("family", PE.SCENARIO_ORDER)
def test_forecaster_fit_matches_reference_and_golden(family):
    got, want = fit_scenario_forecaster(family), ref_fit(family)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    golden = json.loads(GOLDEN.read_text())[family]
    assert [got.mean, *got.cos_coeffs, *got.sin_coeffs] == golden


# ------------------------- engine, simulator, policies -----------------------


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_one_day_matches_reference(scheduler, policy):
    """Every SimResult field, the config trace and the utilization histogram ==."""
    kw = dict(scheduler=scheduler, scenario="paper-diurnal", seed=SCHEDULERS.index(scheduler) + 500,
              **POLICIES[policy])
    got, want = _both(kw)
    assert got == want
    assert got["num_jobs"] > 300 and got["config_trace"][0][0] == 0.0


@pytest.mark.parametrize("mode", ["partial", "drain"])
@pytest.mark.parametrize("policy", ["forecast", "heuristic"])
def test_snapshot_mid_run_matches_reference(policy, mode):
    """``snapshot_of`` (through ``engine.snapshot``) at a paused mid-day instant."""
    jobs_p = generate_scenario("bursty-mmpp", seed=4)
    jobs_r = ref_scenario("bursty-mmpp", seed=4)
    cell = PC.make_cell(experiment="t", group="t", scheduler="LLF", seed=4, scenario="bursty-mmpp",
                        **POLICIES[policy])
    kwargs = PC._cell_policy_kwargs({**cell, "repartition_mode": mode})
    pe = SimulationEngine(MIGSimulator(make_scheduler("LLF"), repartition_mode=mode),
                          PC.make_policy(policy, kwargs), jobs=jobs_p)
    re_ = RefEngine(RefSim(ref_scheduler("LLF"), repartition_mode=mode),
                    RC.make_policy(policy, kwargs), jobs=jobs_r)
    for t in (300.0, 731.5, 1100.0):
        assert pe.run_until(t) == re_.run_until(t)
        a, b = pe.snapshot(), re_.snapshot()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.sim.jobs_in_system > 0 or t == 300.0
    pe.drain(), re_.drain()
    assert dataclasses.asdict(pe.result()) == dataclasses.asdict(re_.result())


@pytest.mark.parametrize("cadence", [None, 15.0])
def test_repartition_env_matches_reference(cadence):
    kw = dict(scenario="heavy-tail-lognormal", decision_interval_min=cadence, max_decisions=400)
    pe, re_ = RepartitionEnv(**kw), RefEnv(**kw)
    o1, o2 = pe.reset(seed=2), re_.reset(seed=2)
    steps = 0
    while True:
        assert o1.dtype == o2.dtype and np.array_equal(o1, o2)
        action = [1, 2, 5, 0, 2, 8][steps % 6]
        o1, r1, d1, t1, i1 = pe.step(action)
        o2, r2, d2, t2, i2 = re_.step(action)
        assert (r1, d1, t1, i1) == (r2, d2, t2, i2)
        steps += 1
        if d1 or t1:
            break
    assert steps > 50
    if d1:
        assert dataclasses.asdict(pe.result()) == dataclasses.asdict(re_.result())


def test_nstep_accumulator_matches_reference():
    class Sink:
        def __init__(self):
            self.seen = []

        def observe(self, *t):
            self.seen.append(t)

    rng = np.random.default_rng(1)
    sinks = Sink(), Sink()
    accs = NStepAccumulator(3, 0.97), RefNStep(3, 0.97)
    for i in range(20):
        r, done = float(rng.normal()), i in (7, 19)
        for acc, sink in zip(accs, sinks):
            acc.push(sink, i, i % 12, r, i + 1, done)
    assert sinks[0].seen == sinks[1].seen and len(sinks[0].seen) == 20


# ----------------------------- cells and registry ----------------------------


@pytest.mark.parametrize("kw", [
    dict(scenario="trace-scaled", scenario_kwargs={"load_scale": 1.5}, policy="forecast",
         policy_kwargs={"scenario": "trace-scaled"}, repartition_mode="drain"),
    dict(scenario="weekend-flat", policy="dqn", policy_kwargs={"params_path": PARAMS},
         mig_enabled=True),
    dict(workload=True, policy="nomig", mig_enabled=False),
])
def test_make_cell_matches_reference_cells(kw):
    from repro.core.workload import WorkloadSpec as RefSpec
    from repro_torch.core.workload import WorkloadSpec

    if kw.pop("workload", False):
        got = PC.make_cell(experiment="e", group="g", scheduler="EDF-SS", seed=7,
                           workload=WorkloadSpec(horizon_min=480.0), **kw)
        want = RC.make_cell(experiment="e", group="g", scheduler="EDF-SS", seed=7,
                            workload=RefSpec(horizon_min=480.0), **kw)
    else:
        got = PC.make_cell(experiment="e", group="g", scheduler="EDF-SS", seed=7, **kw)
        want = RC.make_scenario_cell(experiment="e", group="g", scheduler="EDF-SS", seed=7, **kw)
    want["policy_kwargs"].pop("_params_digest", None)
    assert got == want


def test_registry_mode_coupling_and_legacy_cells():
    cell = {"policy": "forecast", "policy_kwargs": {"scenario": "bursty-mmpp"}}
    assert PC.cell_repartition_mode(cell) == "drain"  # a cell without the key is legacy
    assert PC._cell_policy_kwargs(cell)["repartition_mode"] == "drain"
    assert PC._cell_policy_kwargs({**cell, "repartition_mode": "partial"})["repartition_mode"] == "partial"
    pinned = {**cell, "policy_kwargs": {"repartition_mode": "partial"}}
    assert PC._cell_policy_kwargs(pinned)["repartition_mode"] == "partial"
    assert PC._cell_policy_kwargs({"policy": "heuristic"}) == {}
    pol = PC.make_policy("static", {"config_id": 5, "_params_digest": "abc"})
    assert pol.initial_config == 5
    assert sorted(PC.POLICIES) == sorted(RC.POLICIES)
    with pytest.raises(KeyError, match="unknown policy"):
        PC.make_policy("oracle-of-delphi")


def test_run_cell_refuses_fleet_and_batched_cells():
    cell = PC.make_cell(experiment="t", group="t", scheduler="EDF-SS", seed=0, scenario="weekend-flat")
    with pytest.raises(NotImplementedError, match="fleet"):
        PC.run_cell({**cell, "fleet": {"devices": [{"profile": "a100-250w"}]}}, device="cpu")
    with pytest.raises(NotImplementedError, match="batched"):
        PC.run_cell({**cell, "backend": "batched"}, device="cpu")


def test_entry_points_raise_without_a_card():
    """No card here: the default device raises; the CPU runs only on request."""
    from repro_torch.core.rl.train import evaluate_policy

    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_policy("static", num_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.load_learner(PARAMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.main(["--table3", "--scale", "0.1"])
    assert len(evaluate_policy("static", num_iterations=1, device="cpu")) == 1


# ------------------------- checked-in sweep rows ----------------------------


def _subset():
    """One seed per group of the policy and mode files, all of the scenario
    matrix, the EDF-SS rows of the smoke sweep."""
    out = []
    for name in ("repartition_policies", "repartition_modes", "scenario_matrix", "smoke_sweep"):
        seen = set()
        for line in (BASELINES / f"{name}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            group = rec["cell"]["group"]
            if name == "smoke_sweep" and rec["cell"]["scheduler"] != "EDF-SS":
                continue
            if name.startswith("repartition_") and group in seen:
                continue
            seen.add(group)
            out.append(pytest.param(rec, id=f"{name}:{group}:{rec['cell']['seed']}"))
    return out


@pytest.mark.parametrize("rec", _subset())
def test_checked_in_row_replays(rec):
    got = PC.run_cell(rec["cell"], device="cpu")
    got.pop("elapsed_s")
    want = rec["result"]
    assert _values_close(got, want, 1e-9) and PE.values_close(got, want, 1e-9)
    assert PE._exact_part(got) == PE._exact_part(want)
    assert PE._max_rel(got, want) <= 1e-9


def test_replay_reports_a_row_that_is_off(tmp_path):
    lines = (BASELINES / "smoke_sweep.jsonl").read_text().splitlines()[:2]
    rec = json.loads(lines[1])
    rec["result"]["preemptions"] += 1
    rec["result"]["energy_wh"] *= 1 + 1e-12
    path = tmp_path / "rows.jsonl"
    path.write_text(lines[0] + "\n" + json.dumps(rec) + "\n")
    out = PE.replay(str(path), 1e-9, device="cpu")
    assert (out["rows"], out["within_rtol"], out["off"]) == (2, 1, [{"group": "EDF-SS", "seed": 17}])
    assert out["max_rel_diff"] < 1e-9
    assert PE.main(["--replay", str(path), "--device", "cpu"]) == 1


# ------------------------------ race and tables -----------------------------


def test_race_matches_the_reference_evaluate(monkeypatch, tmp_path):
    """Two families through ``scripts/train_rl_baseline.py``'s ``evaluate`` and the
    port's race: equal rows, equal to ``rl_batched.json``'s."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import train_rl_baseline

    families = ("paper-diurnal", "weekend-flat")
    monkeypatch.chdir(tmp_path)  # the reference's sweep cache lands here
    monkeypatch.setattr(RG, "SCENARIO_ORDER", families)
    want = train_rl_baseline.evaluate(PARAMS, scale=0.1)
    learner = PE.load_learner(PARAMS, "cpu")
    log = PE.DecisionLog(learner)
    got, per = PE.race(log, 0.1, families=families, device="cpu")
    assert got == want
    checked = {r["scenario"]: r for r in json.loads((BASELINES / "rl_batched.json").read_text())["rows"]}
    assert got == [checked[f] for f in families]
    assert {len(v) for p in per.values() for v in p.values()} == {4}
    assert len(log.records) > 4 * 96 and {r[0] for r in log.records} == set(families)
    assert PE.action_flips(log, learner) == []


def test_table3_matches_reference_grid(monkeypatch):
    monkeypatch.setattr(RG, "DQN_PARAMS_PATH", PARAMS)
    cells = RG._table3_cells(0.1)
    want = RG._table3_aggregate(cells, [RC.run_cell(c) for c in cells])
    got = PE.table3(0.1, PARAMS, device="cpu")
    assert got == want
    assert [r["model"] for r in got] == ["NoMIG", "StaticMIG", "DayNightMIG",
                                         "DynamicMIG-heuristic", "DynamicMIG-DQN"]
    ours = PE.table3_cells(0.1, PARAMS)
    for c in cells:
        c["policy_kwargs"].pop("_params_digest", None)
    assert ours == cells


def test_cli_table3_and_race_args(capsys):
    assert PE.main(["--table3", "--scale", "0.1", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["model"] for r in rows] == ["NoMIG", "StaticMIG", "DayNightMIG", "DynamicMIG-heuristic"]
    assert rows[0]["improvement_vs_NoMIG_pct"] == 0.0
    with pytest.raises(SystemExit):
        PE.main(["--race", "--device", "cpu"])  # --race needs --params


def _write_golden() -> None:
    fits = {f: ref_fit(f) for f in PE.SCENARIO_ORDER}
    GOLDEN.write_text(json.dumps(
        {f: [m.mean, *m.cos_coeffs, *m.sin_coeffs] for f, m in fits.items()}, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_eval.py --write-golden")
    _write_golden()
