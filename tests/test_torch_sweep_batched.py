"""The port's batched sweep route (``repro_torch.sweep.batched``, ``BatchedResult.to_result_dicts``, the runner's batched groups) against the JAX package's, on the CPU.

Case for case as ``tests/test_batched_sweep.py`` holds the reference's: the
``backend`` keys in cells and hashes, grouping by physics-minus-seed, the
refusals (fleet cells, schedulers other than EDF-FS, serving cells, stateful
policies, ad-hoc policy factories) with the reference's messages, the
result vocabulary, the runner's grouping, caching and grid order.  Then the
results themselves:

* ``run_batched_cells`` against the reference's on the same cells: integers
  exact, floats at ``tests/test_torch_sim.py``'s port-vs-reference bars
  (``tests/torch_sweep_golden.py``'s ``batched_off``);
* against the event-driven oracle on the same cells, within BATCHED_SIM.md
  §4 (``oracle_off``; ``num_jobs`` and ``repartitions`` exact);
* the golden file's batched cells (the reference's 3 x 64 paper-diurnal
  days, which ``chip_smoke.py`` holds the card to): their hashes, and the
  port's CPU run of the first seeds of each group.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_sweep_batched.py``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.batched as RBatch
import repro.sweep.batched as RB
import repro.sweep.cells as RC
import repro_torch.core.batched as PBatch
import repro_torch.sweep.batched as PB
import repro_torch.sweep.cells as PC
from repro.sweep.runner import run_cells as ref_run_cells
from repro_torch.core.batched import UnsupportedPolicyError
from repro_torch.sweep.runner import run_cells

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sweep_golden as G  # noqa: E402

# the reference's cells at load 0.1 (tests/test_batched_sweep.py), cut to
# the first 8 hours of the day to keep the file fast
_KW = {"load_scale": 0.1, "horizon_min": 480.0}
# the route against the reference and the oracle: paper-diurnal at load 0.2
# (tests/test_torch_sim.py's agreement load) over the first 16 hours, which
# span DayNight's morning switch, 3 seeds a policy
LOAD = {"load_scale": 0.2, "horizon_min": 960.0}
SEEDS = range(3)
POLICIES = [(p, kw, mig) for _, p, kw, mig in G.BATCHED_POLICIES]
GOLDEN_SEEDS = 4  # of each golden group, run again on the CPU


@pytest.fixture(autouse=True)
def _own_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _cell(mod=PC, seed=0, backend="batched", policy="daynight", scenario_kwargs=_KW, **kw):
    return mod.make_scenario_cell(
        experiment="t", group="g", scheduler="EDF-FS", scenario="paper-diurnal", seed=seed,
        scenario_kwargs=scenario_kwargs, policy=policy, backend=backend, **kw)


def _route_cells(mod, policy, kwargs, mig):
    return [_cell(mod, seed=s, policy=policy, policy_kwargs=kwargs, mig_enabled=mig,
                  scenario_kwargs=LOAD) for s in SEEDS]


# ------------------------------ cells and hashes ------------------------------


def test_oracle_cells_carry_no_backend_key():
    cell = _cell(backend="oracle")
    assert "backend" not in cell and "backend_kwargs" not in cell
    assert not PB.is_batched_cell(cell)
    assert cell == _cell(RC, backend="oracle")


def test_batched_cells_hash_apart_from_oracle():
    oracle, batched = _cell(backend="oracle"), _cell(backend="batched")
    assert batched["backend"] == "batched" and batched["backend_kwargs"] == {"dt_min": 0.5}
    assert PB.is_batched_cell(batched)
    assert PC.cell_hash(oracle) != PC.cell_hash(batched)
    coarse = _cell(backend="batched", backend_kwargs={"dt_min": 1.0})
    assert PC.cell_hash(coarse) != PC.cell_hash(batched)
    for c, ref in ((batched, _cell(RC)), (coarse, _cell(RC, backend_kwargs={"dt_min": 1.0}))):
        assert c == ref and PC.cell_hash(c) == RC.cell_hash(ref)
    assert PBatch.DEFAULT_DT_MIN == RBatch.DEFAULT_DT_MIN


def test_backend_validation_errors():
    for kw, match in (({"backend": "gpu"}, "unknown backend"),
                      ({"backend": "oracle", "backend_kwargs": {"dt_min": 1.0}}, "backend_kwargs")):
        with pytest.raises(ValueError, match=match) as got:
            _cell(**kw)
        with pytest.raises(ValueError) as want:
            _cell(RC, **kw)
        assert str(got.value) == str(want.value)
    from repro_torch.core.workload import WorkloadSpec

    cell = PC.make_cell(experiment="t", group="g", scheduler="EDF-FS", workload=WorkloadSpec(), seed=0,
                        backend="batched")
    assert cell["backend"] == "batched"


def test_group_key_collapses_seeds_only():
    a, b = _cell(seed=0), _cell(seed=1)
    assert PB.batched_group_key(a) == PB.batched_group_key(b) == RB.batched_group_key(_cell(RC, seed=0))
    assert PB.batched_group_key(a) != PB.batched_group_key(_cell(seed=0, backend_kwargs={"dt_min": 1.0}))
    assert PB.batched_group_key(a) != PB.batched_group_key(_cell(seed=0, policy="nomig"))


# ------------------------------ refusals ------------------------------


def _bad_cells(mod):
    wrong_scheduler = dict(_cell(mod), scheduler="EDF-SS")
    fleet = mod.make_fleet_cell(experiment="t", group="g", profiles=["a100"], dispatcher="jsq",
                                scheduler="EDF-FS", scenario="paper-diurnal", seed=0, scenario_kwargs=_KW)
    fleet["backend"] = "batched"
    serving = mod.make_scenario_cell(experiment="t", group="g", scheduler="EDF-FS",
                                     scenario="multi-tenant-serving", seed=0, backend="batched")
    return {"scheduler": wrong_scheduler, "fleet": fleet, "serving": serving,
            "heuristic": _cell(mod, policy="heuristic"),
            "forecast": _cell(mod, policy="forecast")}


@pytest.mark.parametrize("case", ["scheduler", "fleet", "serving", "heuristic", "forecast"])
def test_unsupported_cells_raise_the_references_error(case):
    """Refused before any simulation, with the reference's message, through
    ``run_batched_cells`` and through ``run_cell``; never run on the oracle."""
    got_cell, ref_cell = _bad_cells(PC)[case], _bad_cells(RC)[case]
    with pytest.raises(RBatch.UnsupportedPolicyError) as want:
        RB.run_batched_cells([ref_cell])
    for call in (lambda: PB.run_batched_cells([got_cell], device="cpu"),
                 lambda: PC.run_cell(got_cell, device="cpu")):
        with pytest.raises(UnsupportedPolicyError) as got:
            call()
        assert str(got.value) == str(want.value)
    if case in ("scheduler", "fleet", "serving"):
        with pytest.raises(UnsupportedPolicyError, match="oracle"):
            PB.validate_batched_cell(got_cell)


def test_policy_factory_rejected_on_batched_cells():
    with pytest.raises(ValueError, match="policy_factory"):
        PC.run_cell(_cell(), policy_factory=lambda: None, device="cpu")
    with pytest.raises(ValueError, match="policy_factory"):
        run_cells("t", [_cell()], cache=False, artifacts_dir=None, policy_factory=lambda: None,
                  device="cpu")


def test_no_card_fails_before_any_work():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.run_batched_cells([_cell()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cells("t", [_cell()], cache=False, artifacts_dir=None)


# ------------------------------ execution ------------------------------


def test_to_result_dicts_matches_reference():
    rng = np.random.default_rng(0)
    B, J, K = 3, 32, 8
    arrays = dict(
        energy_wh=rng.uniform(1e3, 5e3, B), tardiness_integral=rng.uniform(0, 1e3, B),
        busy_slot_minutes=rng.uniform(1e3, 9e3, B), preemptions=rng.integers(0, 50, B),
        repartitions=rng.integers(0, 9, B), completion=rng.uniform(0, 1500, (B, J)),
        deadline=rng.uniform(0, 1500, (B, J)), valid=rng.uniform(size=(B, J)) < 0.8,
        num_jobs=np.zeros(B, np.int64), makespan_min=rng.uniform(1400, 1600, B),
        util_histogram=np.where(rng.uniform(size=(B, K)) < 0.5, 0.0, rng.uniform(0, 600, (B, K))),
    )
    arrays["num_jobs"] = arrays["valid"].sum(1)
    got = PBatch.BatchedResult(**arrays).to_result_dicts()
    want = RBatch.BatchedResult(**arrays).to_result_dicts()
    assert got == want and all(r["config_trace"] == [] for r in got)
    assert all(all(v > 0 for v in r["util_histogram"].values()) for r in got)


def test_run_cell_schema_matches_oracle_backend():
    oracle = PC.run_cell(_cell(backend="oracle"), device="cpu")
    batched = PC.run_cell(_cell(backend="batched"), device="cpu")
    assert set(batched) == set(oracle)
    assert batched["config_trace"] == []
    assert batched["num_jobs"] == oracle["num_jobs"] and batched["repartitions"] == oracle["repartitions"]
    assert batched["energy_wh"] == pytest.approx(oracle["energy_wh"], rel=0.03)
    sr = PC.result_to_sim_result(batched)
    assert sr.energy_wh == batched["energy_wh"] and sr.extra["makespan_min"] > 0


def test_runner_groups_and_caches_batched_cells(tmp_path):
    cells = [_cell(seed=s) for s in range(4)]
    kw = dict(cache=str(tmp_path / "cache"), artifacts_dir=str(tmp_path / "art"), device="cpu")
    out = run_cells("batched_grid", cells, **kw)
    assert out.computed_count == 4 and out.cached_count == 0
    energies = [r["energy_wh"] for r in out.results]
    assert all(r["num_jobs"] > 0 for r in out.results) and len(set(energies)) == len(energies)
    solo = PC.run_cell(cells[2], device="cpu")
    assert out.results[2]["energy_wh"] == pytest.approx(solo["energy_wh"], rel=1e-6)
    again = run_cells("batched_grid", cells, **kw)
    assert again.cached_count == 4 and again.computed_count == 0 and again.results == out.results
    lines = (tmp_path / "art" / "batched_grid.jsonl").read_text().splitlines()
    assert [json.loads(x)["hash"] for x in lines] == [RC.cell_hash(_cell(RC, seed=s)) for s in range(4)]


def test_runner_mixes_backends_in_one_grid(tmp_path):
    cells = [_cell(seed=0, backend="oracle"), _cell(seed=0), _cell(seed=1, backend="oracle"), _cell(seed=1)]
    out = run_cells("mixed_grid", cells, workers=2, cache=False, artifacts_dir=str(tmp_path / "art"),
                    device="cpu")
    assert out.computed_count == 4
    assert [r["config_trace"] != [] for r in out.results] == [True, False, True, False]
    for o, b in ((0, 1), (2, 3)):
        assert out.results[b]["energy_wh"] == pytest.approx(out.results[o]["energy_wh"], rel=0.03)
    assert out.results[0] == {k: v for k, v in PC.run_cell(cells[0], device="cpu").items()
                              if k != "elapsed_s"}
    # the grid order of the artifact is the reference's
    ref = ref_run_cells("mixed_grid", [_cell(RC, seed=s, backend=b) for s in (0, 1)
                                       for b in ("oracle", "batched")],
                        cache=False, artifacts_dir=str(tmp_path / "ref"))
    got_lines = [json.loads(x) for x in (tmp_path / "art" / "mixed_grid.jsonl").read_text().splitlines()]
    assert [r["hash"] for r in got_lines] == ref.hashes
    assert got_lines[0]["result"] == ref.results[0]  # the oracle cell: the reference's exactly


def test_batched_seed_determinism():
    a = PB.run_batched_cells([_cell(seed=3)], device="cpu")[0]
    b = PB.run_batched_cells([_cell(seed=3)], device="cpu")[0]
    for k in ("energy_wh", "avg_tardiness", "busy_slot_minutes", "preemptions", "repartitions",
              "util_histogram"):
        assert a[k] == b[k], k


@pytest.fixture(scope="module")
def route_results():
    """One ``run_batched_cells`` call a package over all three policies'
    cells (three groups), and the oracle's run of each cell."""
    port_cells = [c for p in POLICIES for c in _route_cells(PC, *p)]
    ref_cells = [c for p in POLICIES for c in _route_cells(RC, *p)]
    assert port_cells == ref_cells
    got = PB.run_batched_cells(port_cells, device="cpu")
    want = RB.run_batched_cells(ref_cells)
    oracle = [PC.run_cell(G.oracle_cell(c), device="cpu") for c in port_cells]
    return port_cells, got, want, oracle


@pytest.mark.parametrize("policy", [p for p, _, _ in POLICIES])
def test_run_batched_cells_matches_reference(route_results, policy):
    cells, got, want, _ = route_results
    rows = [i for i, c in enumerate(cells) if c["policy"] == policy]
    assert len(rows) == len(SEEDS)
    for i in rows:
        assert set(got[i]) == set(want[i])
        assert G.batched_off(got[i], want[i]) == [], (policy, cells[i]["seed"])
    assert len({got[i]["energy_wh"] for i in rows}) == len(rows)


@pytest.mark.parametrize("policy", [p for p, _, _ in POLICIES])
def test_run_batched_cells_agrees_with_the_oracle(route_results, policy):
    cells, got, _, oracle = route_results
    for i, c in enumerate(cells):
        if c["policy"] == policy:
            assert G.oracle_off(got[i], oracle[i]) == [], (policy, c["seed"])
            assert got[i]["num_jobs"] > 0


def test_oracle_off_reads_the_bar():
    o = {"num_jobs": 100, "repartitions": 4, "energy_wh": 1000.0, "avg_tardiness": 2.0,
         "busy_slot_minutes": 5000.0, "preemptions": 40}
    assert G.oracle_off(dict(o, energy_wh=1029.0, avg_tardiness=2.9, busy_slot_minutes=5120.0,
                             preemptions=55), o) == []
    assert G.oracle_off(dict(o, energy_wh=1031.0, avg_tardiness=3.1, busy_slot_minutes=5130.0,
                             preemptions=57, repartitions=5), o) == [
        "repartitions", "energy_wh", "avg_tardiness", "busy_slot_minutes", "preemptions"]


# ------------------------------ the golden file ------------------------------


def test_golden_batched_cells_and_first_seeds():
    """The golden file's cells are both packages' (hash for hash); the port's
    CPU run of the first seeds of each group holds the reference's results."""
    golden = json.loads(G.GOLDEN.read_text())["batched"]
    cells = G.batched_cells(PC.make_scenario_cell)
    assert cells == G.batched_cells(RC.make_scenario_cell)
    assert G.hash_digest([PC.cell_hash(c) for c in cells]) == golden["hashes"]
    n = len(G.BATCHED_SEEDS)
    assert len(golden["results"]) == len(cells) == n * len(G.BATCHED_POLICIES)
    rows = [g * n + s for g in range(len(G.BATCHED_POLICIES)) for s in range(GOLDEN_SEEDS)]
    got = PB.run_batched_cells([cells[i] for i in rows], device="cpu")
    for i, out in zip(rows, got):
        out.pop("elapsed_s")
        assert G.batched_off(out, golden["results"][i]) == [], cells[i]["group"]
