"""The port's sweep engine (``repro_torch.sweep``: cells, hashes, cache, runner, grids, CLI) against the JAX package's ``repro.sweep``, on the CPU.

The engine is float64 host code copied with the reference's order of
operations and cell enumeration, so the bars are ``==`` for cells and hashes
and the reference's baseline tolerance (rtol 1e-9, integers exact) for
aggregate rows:

* every one of the 14 grids builds the reference's cells, dict for dict and
  hash for hash, at scales 0.1, 0.5 and 1.0, with and without
  ``artifacts/dqn_params.npz`` in the working directory;
* the paper grids' aggregates: the cheap grids end to end through both
  packages' ``run_grid``, Table II and Figs. 7-10 through both packages'
  aggregates on one set of result dicts, and the cheap grids at scale 1.0
  against the golden file that ``chip_smoke.py`` holds the card to;
* the runner and the cache, case for case as ``tests/test_sweep.py`` holds
  the reference's.

The seven checked-in baselines go through the port's CLI in
``tests/test_torch_sweep_baselines.py``, the batched route in
``tests/test_torch_sweep_batched.py``.  Every test runs in its own working
directory, so no cache, artifact or DQN file of one package or test is read
by another.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_sweep.py``.
Rewrite the golden file (the reference's seven paper grids at scale 1.0,
twice, and the batched cells; a few minutes):
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write-golden``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

import repro.sweep.cells as RC
import repro.sweep.grids as RG
import repro_torch.core.metrics as PM
import repro_torch.sweep.cells as PC
import repro_torch.sweep.grids as PG
from repro.core.workload import WorkloadSpec as RefSpec
from repro.sweep import run_cells as ref_run_cells
from repro.sweep import run_grid as ref_run_grid
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import SIM_VERSION, MIGSimulator, StaticPolicy
from repro_torch.core.workload import WorkloadSpec, generate_jobs
from repro_torch.sweep import (
    GRIDS,
    StaleCacheError,
    SweepCache,
    cell_hash,
    make_cell,
    make_scenario_cell,
    result_to_sim_result,
    run_cell,
    run_cells,
    run_grid,
)
from repro_torch.sweep.__main__ import check_baseline, main

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sweep_golden as G  # noqa: E402

TINY = WorkloadSpec(horizon_min=90.0, constant_rate=0.2)
SCALES = (0.1, 0.5, 1.0)
# grids cheap enough to run end to end through both packages at scale 0.1
CHEAP_PAPER_GRIDS = [("fig4_preemption", False), ("fig6_utilization", False),
                     ("table3_repartitioning", False), ("table3_repartitioning", True),
                     ("fig11_preferences", False), ("fig11_preferences", True)]
# the golden file's grids the CPU runs again at scale 1.0
GOLDEN_CHEAP = ("fig6_utilization", "table3_repartitioning", "fig11_preferences")


@pytest.fixture(autouse=True)
def _own_cwd(tmp_path, monkeypatch):
    """Each test in its own working directory: the default cache, artifacts
    and the grids' relative DQN_PARAMS_PATH all resolve there."""
    monkeypatch.chdir(tmp_path)


def _with_dqn_file(dqn: bool) -> None:
    if dqn:
        os.makedirs("artifacts", exist_ok=True)
        shutil.copyfile(G.RL_PARAMS, G.DQN_PARAMS_PATH)


def _tiny_cells(n_seeds=4, experiment="t", group="EDF-SS"):
    return [
        make_cell(experiment=experiment, group=group, scheduler="EDF-SS", workload=TINY, seed=s,
                  policy="static", policy_kwargs={"config_id": 3})
        for s in range(n_seeds)
    ]


# ------------------------------ cells and hashes ------------------------------


def test_registry_and_constants_match_reference():
    assert list(PG.GRIDS) == list(RG.GRIDS)
    assert [(g.name, g.doc) for g in PG.GRIDS.values()] == [(g.name, g.doc) for g in RG.GRIDS.values()]
    assert PG.POLICY_FAMILIES == RG.POLICY_FAMILIES
    assert PG.SCENARIO_ORDER == RG.SCENARIO_ORDER and PG.ALGOS == RG.ALGOS
    assert PG.DQN_PARAMS_PATH == RG.DQN_PARAMS_PATH == G.DQN_PARAMS_PATH
    assert PG.REPARTITION_MODE_FAMILIES == RG.REPARTITION_MODE_FAMILIES
    assert [PG._iters(b, s, f) for b in (2, 10) for s in SCALES for f in (1, 4)] == [
        RG._iters(b, s, f) for b in (2, 10) for s in SCALES for f in (1, 4)]
    assert PG.summarize_results is PM.summarize_results  # the one copy


@pytest.mark.parametrize("dqn", [False, True], ids=["no_dqn_file", "dqn_file"])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("grid", list(RG.GRIDS))
def test_grid_cells_and_hashes_match_reference(grid, scale, dqn):
    _with_dqn_file(dqn)
    got, want = PG.GRIDS[grid].build(scale), RG.GRIDS[grid].build(scale)
    assert got == want
    assert [PC.cell_hash(c) for c in got] == [RC.cell_hash(c) for c in want]
    assert len({PC.cell_hash(c) for c in got}) == len(got), "duplicate cells"


def test_dqn_file_changes_exactly_the_reference_grids():
    before = {g: [PC.cell_hash(c) for c in PG.GRIDS[g].build(0.1)] for g in PG.GRIDS}
    _with_dqn_file(True)
    after = {g: [PC.cell_hash(c) for c in PG.GRIDS[g].build(0.1)] for g in PG.GRIDS}
    changed = sorted(g for g in PG.GRIDS if before[g] != after[g])
    assert changed == sorted(G.DQN_GRIDS + ("repartition_policies",))
    dqn_cell = next(c for c in PG.GRIDS["table3_repartitioning"].build(0.1) if c["policy"] == "dqn")
    assert dqn_cell["policy_kwargs"]["_params_digest"] == PC.file_digest(str(G.RL_PARAMS))


def test_cell_hash_deterministic_and_content_addressed():
    a, b = _tiny_cells(1)[0], _tiny_cells(1)[0]
    assert cell_hash(a) == cell_hash(b)
    for changed in (dict(a, seed=99), dict(a, scheduler="LLF"), dict(a, policy_kwargs={"config_id": 4})):
        assert cell_hash(changed) != cell_hash(a)
        assert cell_hash(changed) == RC.cell_hash(changed)


def test_dqn_cells_hash_weights_content_not_just_path(tmp_path):
    params = tmp_path / "dqn_params.npz"
    params.write_bytes(b"weights-v1")
    kw = dict(experiment="t", group="dqn", scheduler="EDF-SS", seed=0, policy="dqn",
              policy_kwargs={"params_path": str(params)})
    cell_v1 = make_cell(workload=TINY, **kw)
    assert cell_v1 == RC.make_cell(workload=RefSpec(horizon_min=90.0, constant_rate=0.2), **kw)
    params.write_bytes(b"weights-v2-retrained")
    cell_v2 = make_cell(workload=TINY, **kw)
    assert cell_hash(cell_v1) != cell_hash(cell_v2)
    # the digest is a hash-only annotation; factories never see it
    assert PC.make_policy("static", {"config_id": 2, "_params_digest": "x"}).initial_config == 2
    # a missing file digests to ''
    assert make_cell(workload=TINY, **{**kw, "policy_kwargs": {"params_path": "nowhere.npz"}})[
        "policy_kwargs"]["_params_digest"] == ""


def test_cell_hash_ignores_grid_labels_but_not_sim_version():
    a = _tiny_cells(1, experiment="x", group="g1")[0]
    b = _tiny_cells(1, experiment="y", group="g2")[0]
    assert cell_hash(a) == cell_hash(b)
    assert cell_hash(a, sim_version="other") != cell_hash(a)
    assert SIM_VERSION == RC.SIM_VERSION and cell_hash(a) == RC.cell_hash(a)
    assert PC.canonical_json({"b": 1.5, "a": [1, None]}) == RC.canonical_json({"b": 1.5, "a": [1, None]})


def test_scenario_cell_resolves_defaults_and_hashes_on_them():
    a = make_scenario_cell(experiment="t", group="g", scheduler="EDF-SS", scenario="weekend-flat", seed=0)
    assert a["scenario"]["kwargs"]["rate_per_min"] == 0.15
    assert a == RC.make_scenario_cell(experiment="t", group="g", scheduler="EDF-SS",
                                      scenario="weekend-flat", seed=0)
    b = make_scenario_cell(experiment="t", group="g", scheduler="EDF-SS", scenario="weekend-flat", seed=0,
                           scenario_kwargs={"rate_per_min": 0.3})
    assert cell_hash(a) != cell_hash(b)
    with pytest.raises(KeyError):
        make_scenario_cell(experiment="t", group="g", scheduler="EDF-SS", scenario="weekend-flat",
                           seed=0, scenario_kwargs={"bogus": 1})


_BAD_SPECS = [
    dict(),
    dict(workload=True, scenario="weekend-flat"),
    dict(workload=True, scenario_kwargs={"load_scale": 2.0}),
    dict(scenario="weekend-flat", fleet_profiles=["a100-250w"]),
    dict(workload=True, dispatcher="round-robin"),
    dict(scenario="weekend-flat", fleet_profiles=["a100-250w"], dispatcher="round-robin", backend="batched"),
    dict(scenario="weekend-flat", fleet_profiles=[], dispatcher="round-robin"),
    dict(workload=True, fleet_profiles=["a100-250w"], dispatcher="round-robin"),
    dict(workload=True, repartition_mode="teleport"),
    dict(workload=True, backend="gpu"),
    dict(workload=True, backend_kwargs={"dt_min": 1.0}),
]


@pytest.mark.parametrize("kw", _BAD_SPECS, ids=range(len(_BAD_SPECS)))
def test_cellspec_refuses_what_the_reference_refuses(kw):
    """``CellSpec``'s refusals, message for message (tests/test_sweep.py:405)."""
    msgs = []
    for mod, spec in ((PC, TINY), (RC, RefSpec(horizon_min=90.0, constant_rate=0.2))):
        args = {k: (spec if k == "workload" else v) for k, v in kw.items()}
        with pytest.raises(ValueError) as e:
            mod.CellSpec(experiment="t", group="g", scheduler="EDF-SS", seed=1, **args).to_cell()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cellspec_and_the_thin_constructors_agree():
    ok = PC.CellSpec(experiment="t", group="g", scheduler="EDF-SS", seed=1, workload=TINY)
    assert ok.to_cell() == make_cell(experiment="t", group="g", scheduler="EDF-SS", seed=1, workload=TINY)
    fleet = dict(experiment="t", group="g", profiles=["a100-250w", "a30-165w"], dispatcher="least-loaded",
                 scheduler="EDF-SS", scenario="weekend-flat", seed=3, dispatch_info="fluid")
    assert PC.make_fleet_cell(**fleet) == RC.make_fleet_cell(**fleet)
    assert PC.make_fleet_cell(**fleet) == PC.CellSpec(
        experiment="t", group="g", scheduler="EDF-SS", seed=3, scenario="weekend-flat",
        fleet_profiles=("a100-250w", "a30-165w"), dispatcher="least-loaded", dispatch_info="fluid").to_cell()


# ------------------------------ run_cell ------------------------------


def test_run_cell_matches_direct_simulation():
    cell = _tiny_cells(1)[0]
    got = result_to_sim_result(run_cell(cell, device="cpu"))
    want = MIGSimulator(make_scheduler("EDF-SS")).run(generate_jobs(TINY, seed=0), policy=StaticPolicy(3))
    assert (got.energy_wh, got.avg_tardiness, got.preemptions, got.num_jobs, got.extra["makespan_min"]) == (
        want.energy_wh, want.avg_tardiness, want.preemptions, want.num_jobs, want.extra["makespan_min"])


def test_paper_diurnal_scenario_cell_matches_workload_cell_results():
    kw = dict(experiment="t", group="g", scheduler="EDF-SS", seed=4, policy="static",
              policy_kwargs={"config_id": 3})
    a = run_cell(make_cell(workload=WorkloadSpec(), **kw), device="cpu")
    b = run_cell(make_scenario_cell(scenario="paper-diurnal", **kw), device="cpu")
    for k in ("energy_wh", "avg_tardiness", "num_jobs", "preemptions", "extra"):
        assert a[k] == b[k], k


def test_group_results_keeps_grid_order():
    cells = _tiny_cells(3, group="a") + _tiny_cells(2, group="b")
    results = run_cells("t", cells, cache=False, artifacts_dir=None, device="cpu").results
    got = PC.group_results(cells, results)
    want = RC.group_results(cells, results)
    assert list(got) == list(want) == ["a", "b"]
    assert {g: [r.energy_wh for r in rs] for g, rs in got.items()} == {
        g: [r.energy_wh for r in rs] for g, rs in want.items()}


# ------------------------------ cache and runner ------------------------------


def test_cache_hit_miss_and_resume(tmp_path):
    cache_dir = str(tmp_path / "cache")
    cells = _tiny_cells(3)
    out1 = run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    assert (out1.cached_count, out1.computed_count) == (0, 3)
    out2 = run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    assert (out2.cached_count, out2.computed_count) == (3, 0)
    assert out2.results == out1.results
    out3 = run_cells("t", cells, cache=cache_dir, resume=False, artifacts_dir=None, device="cpu")
    assert (out3.cached_count, out3.computed_count) == (0, 3)
    assert out3.results == out1.results
    out4 = run_cells("t", _tiny_cells(4), cache=cache_dir, artifacts_dir=None, device="cpu")
    assert (out4.cached_count, out4.computed_count) == (3, 1)
    # the reference's results for the same cells, computed in a cache of its own
    ref = ref_run_cells("t", _tiny_cells(4), cache=str(tmp_path / "ref"), artifacts_dir=None)
    assert ref.results == out4.results and ref.hashes == out4.hashes
    # the entries are the reference's layout: <hash>.<SIM_VERSION>.json
    assert sorted(os.listdir(cache_dir)) == sorted(os.listdir(tmp_path / "ref"))


def test_cache_rejects_torn_and_foreign_entries(tmp_path):
    cache = SweepCache(str(tmp_path))
    cell = _tiny_cells(1)[0]
    h = cell_hash(cell)
    assert cache.get(h) is None
    cache.put(h, cell, {"energy_wh": 1.0})
    assert cache.get(h) == {"energy_wh": 1.0}
    assert (cache.hits, cache.misses) == (1, 1)
    with open(cache._path(h), "w") as f:
        f.write('{"sim_version": "mig-sim')
    assert cache.get(h) is None
    with open(cache._path(h), "w") as f:
        json.dump({"sim_version": "ancient", "cell": cell, "result": {}}, f)
    assert cache.get(h) is None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_ad_hoc_policy_bypasses_cache(tmp_path):
    cache_dir = str(tmp_path / "cache")
    out = run_cells("t", _tiny_cells(2), cache=cache_dir, artifacts_dir=None,
                    policy_factory=lambda: StaticPolicy(3), device="cpu")
    assert out.computed_count == 2
    assert len(SweepCache(cache_dir)) == 0
    assert out.results == run_cells("t", _tiny_cells(2), cache=False, artifacts_dir=None,
                                    device="cpu").results


def _plant_stale(cache_dir):
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "0" * 64 + ".mig-sim-0.json"), "w") as f:
        json.dump({"sim_version": "mig-sim-0", "cell": {}, "result": {}}, f)
    with open(os.path.join(cache_dir, "1" * 64 + ".json"), "w") as f:
        json.dump({"sim_version": "mig-sim-0", "cell": {}, "result": {}}, f)


def test_resume_refuses_stale_sim_version(tmp_path, capsys):
    cache_dir = str(tmp_path / "cache")
    cells = _tiny_cells(2)
    run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    _plant_stale(cache_dir)
    with pytest.raises(StaleCacheError, match="different\\s+simulator version"):
        run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    with pytest.raises(StaleCacheError, match="repro_torch.sweep --purge-stale-cache"):
        run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    # the CLI exits 2 on it
    assert main(["smoke", "--scale", "0.05", "--cache-dir", cache_dir, "--device", "cpu"]) == 2
    assert "ERROR" in capsys.readouterr().err
    out = run_cells("t", cells, cache=cache_dir, artifacts_dir=None, resume=False, device="cpu")
    assert out.computed_count == 2
    with pytest.raises(StaleCacheError):
        run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    assert SweepCache(cache_dir).purge_stale() == 2
    out2 = run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    assert (out2.cached_count, out2.computed_count) == (2, 0)


def test_clean_cache_resume_still_works(tmp_path):
    cache_dir = str(tmp_path / "cache")
    cells = _tiny_cells(3)
    run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    out = run_cells("t", cells, cache=cache_dir, artifacts_dir=None, device="cpu")
    assert (out.cached_count, out.computed_count) == (3, 0)


def test_cli_purge_without_grid_is_purge_only(tmp_path, capsys):
    cache_dir = str(tmp_path / "cache")
    os.makedirs(cache_dir)
    with open(os.path.join(cache_dir, "a" * 64 + ".mig-sim-0.json"), "w") as f:
        json.dump({"sim_version": "mig-sim-0", "cell": {}, "result": {}}, f)
    assert main(["--purge-stale-cache", "--cache-dir", cache_dir]) == 0
    assert len(SweepCache(cache_dir)) == 0
    out = capsys.readouterr()
    assert "purged 1" in out.err and "###" not in out.out


def test_cli_lists_grids_and_refuses_what_the_reference_refuses(tmp_path, capsys):
    assert main(["--list"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(RG.GRIDS)
    baseline = tmp_path / "b.jsonl"
    baseline.write_text("")
    for argv in (["smoke", "fleet_scaling", "--check-baseline", str(baseline)],
                 ["no_such_grid"], ["smoke", "--check-baseline", str(tmp_path / "missing.jsonl")]):
        with pytest.raises(SystemExit):
            main(argv)


def test_worker_count_independence_and_jsonl_artifact(tmp_path):
    cells = [
        make_cell(experiment="t", group=n, scheduler=n, workload=TINY, seed=s, policy="static",
                  policy_kwargs={"config_id": cfg})
        for n in ("EDF-SS", "LLF") for cfg in (2, 3) for s in range(2)
    ]
    a0, a2 = str(tmp_path / "a0"), str(tmp_path / "a2")
    out0 = run_cells("grid", cells, workers=0, cache=False, artifacts_dir=a0, device="cpu")
    out2 = run_cells("grid", cells, workers=2, cache=False, artifacts_dir=a2, device="cpu")
    assert out0.results == out2.results
    b0 = open(os.path.join(a0, "grid.jsonl"), "rb").read()
    assert b0 == open(os.path.join(a2, "grid.jsonl"), "rb").read()
    lines = [json.loads(x) for x in b0.decode().splitlines()]
    assert len(lines) == len(cells) and all(set(rec) == {"hash", "cell", "result"} for rec in lines)
    assert [rec["cell"]["seed"] for rec in lines] == [c["seed"] for c in cells]
    assert all("elapsed_s" not in rec["result"] for rec in lines)
    meta = json.loads(open(os.path.join(a2, "grid.meta.json")).read())
    assert (meta["cells"], meta["computed"], meta["workers"]) == (len(cells), len(cells), 2)
    # the reference's artifact of the same grid, byte for byte
    ref_run_cells("grid", cells, workers=0, cache=False, artifacts_dir=str(tmp_path / "r"))
    assert b0 == open(tmp_path / "r" / "grid.jsonl", "rb").read()


def test_parallel_failure_reports_cell():
    bad = _tiny_cells(2)
    bad[1]["policy"] = "nonexistent-policy"
    with pytest.raises(RuntimeError, match="sweep cell failed: .*nonexistent-policy"):
        run_cells("t", bad, workers=2, cache=False, artifacts_dir=None, device="cpu")


def test_check_baseline_detects_drift(tmp_path):
    out = run_cells("base", _tiny_cells(2), cache=False, artifacts_dir=str(tmp_path), device="cpu")
    baseline = str(tmp_path / "baseline.jsonl")
    shutil.copy(out.jsonl_path, baseline)
    assert check_baseline(out.jsonl_path, baseline, rtol=1e-9) == 0
    lines = [json.loads(x) for x in open(baseline)]
    lines[0]["result"]["energy_wh"] *= 1.001
    with open(baseline, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    assert check_baseline(out.jsonl_path, baseline, rtol=1e-9) == 1
    assert check_baseline(out.jsonl_path, baseline, rtol=0.01) == 0
    with open(baseline, "a") as f:
        f.write(json.dumps({**lines[0], "hash": "f" * 64}) + "\n")
    assert check_baseline(out.jsonl_path, baseline, rtol=0.01) == 2  # a miss and the size


def test_grids_build_and_smoke_aggregates(tmp_path):
    for name, grid in GRIDS.items():
        cells = grid.build(0.1)
        assert cells and len({cell_hash(c) for c in cells}) == len(cells), name
    kw = dict(scale=0.05, workers=0, cache=str(tmp_path / "c"), artifacts_dir=str(tmp_path / "a"))
    rows, outcome = run_grid("smoke", device="cpu", **kw)
    assert [r["algorithm"] for r in rows] == ["EDF-FS", "EDF-SS", "LLF", "LALF"]
    assert os.path.exists(outcome.jsonl_path)
    rows2, outcome2 = run_grid("smoke", device="cpu", **kw)
    assert rows2 == rows and outcome2.computed_count == 0
    with pytest.raises(KeyError, match="unknown grid"):
        run_grid("no_such_grid", device="cpu")


def test_no_card_fails_before_any_work(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cells("t", _tiny_cells(1), cache=str(tmp_path / "c"), artifacts_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["smoke", "--scale", "0.05", "--cache-dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists() and not (tmp_path / "a").exists()


def test_evaluate_policy_through_the_runner_matches_reference(tmp_path, monkeypatch):
    from repro.core.rl.train import evaluate_policy as ref_eval
    from repro_torch.core.rl.train import evaluate_policy

    kw = dict(num_iterations=3, scenario="weekend-flat", scenario_kwargs={"horizon_min": 240.0}, seed=5)
    got = evaluate_policy("heuristic", workers=2, device="cpu", **kw)
    assert len(SweepCache(os.path.join("artifacts", "sweeps", "cache"))) == 3  # registered: cached
    again = evaluate_policy("heuristic", device="cpu", **kw)
    monkeypatch.chdir(tmp_path / "artifacts")  # the reference's cache apart from the port's
    want = ref_eval("heuristic", **kw)
    assert got == again
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]


# ------------------------------ paper grids ------------------------------


@pytest.mark.parametrize("grid, dqn", CHEAP_PAPER_GRIDS,
                         ids=[f"{g}-{'dqn' if d else 'no_dqn'}" for g, d in CHEAP_PAPER_GRIDS])
def test_paper_grid_end_to_end_matches_reference(tmp_path, grid, dqn):
    _with_dqn_file(dqn)
    got, outcome = run_grid(grid, scale=0.1, cache=str(tmp_path / "p"), artifacts_dir=None, device="cpu")
    want, ref_outcome = ref_run_grid(grid, scale=0.1, cache=str(tmp_path / "r"), artifacts_dir=None)
    assert outcome.hashes == ref_outcome.hashes
    assert G.rows_off(got, want) == []
    assert any(c["policy"] == "dqn" for c in outcome.cells) == dqn


@pytest.mark.parametrize("grid", ["table2_schedulers", "fig7_fig8_arrival", "fig9_fig10_split"])
def test_paper_aggregates_on_the_same_results_match_reference(grid):
    cells = PG.GRIDS[grid].build(0.1)
    assert cells == RG.GRIDS[grid].build(0.1)
    results = run_cells(grid, cells, workers=2, cache=False, artifacts_dir=None, device="cpu").results
    got = PG.GRIDS[grid].aggregate(cells, results)
    want = RG.GRIDS[grid].aggregate(cells, results)
    assert got == want
    assert len(got) == {"table2_schedulers": 4, "fig7_fig8_arrival": 36, "fig9_fig10_split": 24}[grid]


# ------------------------------ the golden file ------------------------------


@pytest.fixture(scope="module")
def golden():
    return json.loads(G.GOLDEN.read_text())


@pytest.mark.parametrize("dqn", [False, True], ids=["no_dqn_file", "dqn_file"])
def test_golden_cells_are_both_packages_grids(golden, dqn):
    _with_dqn_file(dqn)
    mode = golden["paper"]["dqn" if dqn else "no_dqn"]
    assert sorted(mode) == sorted(G.DQN_GRIDS if dqn else G.PAPER_GRIDS)
    for name, want in mode.items():
        cells = PG.GRIDS[name].build(golden["run"]["scale"])
        hashes = [PC.cell_hash(c) for c in cells]
        assert hashes == [RC.cell_hash(c) for c in RG.GRIDS[name].build(golden["run"]["scale"])]
        assert (len(cells), G.hash_digest(hashes)) == (want["cells"], want["hashes"]), name


@pytest.mark.parametrize("dqn", [False, True], ids=["no_dqn_file", "dqn_file"])
def test_golden_rows_of_the_cheap_grids(golden, dqn):
    """The port's fig6, table3 and fig11 at scale 1.0 against the reference's rows."""
    _with_dqn_file(dqn)
    mode = golden["paper"]["dqn" if dqn else "no_dqn"]
    names = [g for g in GOLDEN_CHEAP if g in mode]
    got = G.run_paper(run_grid, names, golden["run"]["scale"], workers=2, cache=False,
                      artifacts_dir=None, device="cpu")
    assert G.paper_off(got, {g: mode[g] for g in names}) == {}


def test_rows_off_reads_the_bar():
    row = {"model": "NoMIG", "ET": 10.0, "preemptions": 3, "ok": True}
    assert G.rows_off([row], [dict(row, ET=10.0 * (1 + 5e-10))]) == []
    assert G.rows_off([row], [dict(row, ET=10.0 * (1 + 2e-9))])[0]["key"] == "ET"
    assert G.rows_off([row], [dict(row, preemptions=3.0)]) == []
    assert G.rows_off([row], [dict(row, preemptions=4)])[0]["key"] == "preemptions"
    assert G.rows_off([row], [dict(row, ok=False)])[0]["key"] == "ok"
    assert G.rows_off([row], [row, row]) == [{"rows": [1, 2]}]


def _write_golden() -> None:
    """The reference's paper grids at scale 1.0 (without and with the DQN file)
    and its batched cells, written to the golden file."""
    import repro.sweep.batched as RB

    paper = {}
    for dqn in (False, True):
        with G.working_dir(dqn):
            got = G.run_paper(ref_run_grid, G.DQN_GRIDS if dqn else G.PAPER_GRIDS, G.SCALE,
                              workers=os.cpu_count() or 1, cache=False, artifacts_dir=None)
        paper["dqn" if dqn else "no_dqn"] = {
            name: {k: v for k, v in g.items() if k in ("cells", "hashes", "rows")} for name, g in got.items()}
        print({name: round(g["seconds"], 1) for name, g in got.items()})
    cells = G.batched_cells(RC.make_scenario_cell)
    results = RB.run_batched_cells(cells)
    for r in results:
        r.pop("elapsed_s")
    G.GOLDEN.write_text(json.dumps({
        "run": {"scale": G.SCALE, "paper_grids": list(G.PAPER_GRIDS), "dqn_grids": list(G.DQN_GRIDS),
                "batched_policies": [list(p) for p in G.BATCHED_POLICIES],
                "batched_seeds": [min(G.BATCHED_SEEDS), max(G.BATCHED_SEEDS)]},
        "paper": paper,
        "batched": {"hashes": G.hash_digest([RC.cell_hash(c) for c in cells]), "results": results},
    }, indent=1) + "\n")
    print(f"wrote {G.GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write-golden")
    _write_golden()
