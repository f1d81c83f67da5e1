"""The port's batched MIG simulator (``repro_torch.core.batched``) against the JAX package's.

The same inputs go through the reference (``repro.core.batched``, jitted on
the CPU as ``tests/test_batched.py`` runs it) and through the port with
``device="cpu"``:

* the host copies (scenarios, tables, padded jobs, compiled policies) are
  bit-exact;
* one step from a mid-rollout state carried across (``state_from_numpy``)
  agrees field by field;
* whole rollouts of ``tests/test_batched.py``'s agreement matrix agree with
  every integer exact;
* two rows hold the reference's event-driven oracle to the BATCHED_SIM.md §4
  tolerances;
* ``tests/data/torch_sim_golden.json`` (the reference's aggregates, which
  ``chip_smoke.py`` holds the card to) is what the reference gives today.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_sim.py``.
Rewrite the golden file (where JAX is):
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py --write-golden``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batched as R
import repro_torch.core.batched as P
from repro.core.batched import backend as RB
from repro.core.engine import SimulationEngine
from repro.core.scenarios import generate_scenario as ref_scenario
from repro.core.schedulers import make_scheduler
from repro.core.simulator import DayNightPolicy as RefDayNight
from repro.core.simulator import MIGSimulator
from repro.core.simulator import NoMIGPolicy as RefNoMIG
from repro.core.simulator import StaticPolicy as RefStatic
from repro_torch.core.batched import backend as PB
from repro_torch.core.scenarios import generate_scenario as port_scenario
from repro_torch.core.simulator import DayNightPolicy, NoMIGPolicy, StaticPolicy

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_sim_golden.json"

# tests/test_batched.py's agreement matrix: scenario, policy, repartition mode
ROWS = [
    ("paper-diurnal", "daynight", "partial"),
    ("paper-diurnal", "static", "drain"),
    ("bursty-mmpp", "static", "partial"),
    ("bursty-mmpp", "daynight", "drain"),
    ("weekend-flat", "nomig", "partial"),
    ("weekend-flat", "daynight", "drain"),
    ("heavy-tail-lognormal", "static", "drain"),
    ("heavy-tail-lognormal", "nomig", "partial"),
]
ROW_IDS = ["/".join(r) for r in ROWS]
SEEDS = range(6)
LOAD = 0.2
SCENARIOS5 = ["paper-diurnal", "bursty-mmpp", "weekend-flat", "heavy-tail-lognormal",
              "heavy-tail-pareto"]

# Port vs reference, whole rollouts.  Both run the same float32 ops in the
# same order except the reductions (a sum over J or over the S lanes may run
# in another order), so integers must be equal and floats sit within a few
# float32 ulps of the per-step sums: energy and busy within 1e-5 relative;
# the tardiness integral, whose per-step sum over J is the longest, within
# 1e-4 relative or 1e-3 absolute; completion times and makespans (minutes,
# values up to ~3e3 where a float32 ulp is 2.4e-4) within 1e-3 absolute.
ENERGY_BUSY_RTOL = 1e-5
TARD_RTOL, TARD_ATOL = 1e-4, 1e-3
MINUTES_ATOL = 1e-3
HIST_ATOL = 1e-3
# one step from one state: a handful of float32 ops on each field
STEP_RTOL = STEP_ATOL = 1e-6
# the golden file is the reference's float32 accumulators; rewritten by the
# same code on another CPU its sums may differ in the last bits only
GOLDEN_RTOL = 1e-6

# agreement with the event-driven oracle (BATCHED_SIM.md §4; measured at dt=0.5)
ENERGY_RTOL = 0.03
TARDINESS_ATOL_MIN = 0.15  # minutes of avg tardiness, OR ...
TARDINESS_RTOL = 0.5  # ... relative to max(oracle, TARDINESS_FLOOR)
TARDINESS_FLOOR = 0.25
BUSY_RTOL = 0.025
PREEMPTIONS_RTOL = 0.4  # relative to max(oracle, PREEMPTIONS_FLOOR)
PREEMPTIONS_FLOOR = 10.0

GOLDEN_FIELDS = ("energy_wh", "tardiness_integral", "busy_slot_minutes", "preemptions",
                 "repartitions", "num_jobs", "makespan_min")
INT_FIELDS = ("preemptions", "repartitions", "num_jobs")


def _ref_policy(name):
    return {"static": lambda: RefStatic(3), "nomig": RefNoMIG, "daynight": RefDayNight}[name]()


def _port_policy(name):
    return {"static": lambda: StaticPolicy(3), "nomig": NoMIGPolicy, "daynight": DayNightPolicy}[name]()


def _ref_inputs(scenario, policy, seeds=SEEDS, load=LOAD):
    tables = R.build_tables()
    lists = [ref_scenario(scenario, seed=s, load_scale=load) for s in seeds]
    jobs = R.BatchedJobs.from_job_lists(lists, max_slots=tables.max_slots)
    return tables, jobs, R.compile_policy(_ref_policy(policy), tables, len(lists))


def _port_inputs(scenario, policy, seeds=SEEDS, load=LOAD):
    tables = P.build_tables()
    lists = [port_scenario(scenario, seed=s, load_scale=load) for s in seeds]
    jobs = P.BatchedJobs.from_job_lists(lists, max_slots=tables.max_slots)
    return tables, jobs, P.compile_policy(_port_policy(policy), tables, len(lists))


def _reference_row(row):
    scenario, policy, mode = row
    tables, jobs, pol = _ref_inputs(scenario, policy)
    return R.simulate_batch(jobs, pol, tables=tables, repartition_mode=mode)


def golden_rows() -> dict:
    """The reference's aggregates for every matrix row (the golden file's content)."""
    rows = {}
    for row in ROWS:
        res = _reference_row(row)
        rows["/".join(row)] = {f: getattr(res, f).tolist() for f in GOLDEN_FIELDS}
    return {"load_scale": LOAD, "seeds": list(SEEDS), "dt_min": R.DEFAULT_DT_MIN, "rows": rows}


@pytest.fixture(scope="module")
def reference_results():
    """The reference's whole rollouts of the matrix, computed once for the module."""
    return {"/".join(row): _reference_row(row) for row in ROWS}


@pytest.fixture(scope="module")
def port_results():
    """The port's whole rollouts of matrix rows on the CPU, each run once for the module."""
    cache = {}

    def get(row):
        if row not in cache:
            scenario, policy, mode = row
            tables, jobs, pol = _port_inputs(scenario, policy)
            cache[row] = P.simulate_batch(jobs, pol, tables=tables, repartition_mode=mode,
                                          device="cpu")
        return cache[row]

    return get


# ----------------------------------------------------------------------
# host copies: bit-exact


@pytest.mark.parametrize("scenario", SCENARIOS5)
def test_scenarios_are_bit_identical(scenario):
    for seed in range(3):
        ref = ref_scenario(scenario, seed=seed, load_scale=LOAD)
        port = port_scenario(scenario, seed=seed, load_scale=LOAD)
        assert len(ref) == len(port) > 0
        for a, b in zip(ref, port):
            assert (a.job_id, a.kind.value, a.arrival, a.work, a.deadline, a.speedup_no_mig) == (
                b.job_id, b.kind.value, b.arrival, b.work, b.deadline, b.speedup_no_mig)
            assert a.elasticity.label == b.elasticity.label
            for k in range(1, 8):
                for mig in (True, False):
                    assert a.rate_on(float(k), mig) == b.rate_on(float(k), mig)


def test_paper_diurnal_at_full_load_is_the_paper_workload():
    from repro_torch.core.workload import WorkloadSpec, generate_jobs

    a = port_scenario("paper-diurnal", seed=4)
    b = generate_jobs(WorkloadSpec(), 4)
    assert [(j.arrival, j.work, j.deadline) for j in a] == [(j.arrival, j.work, j.deadline) for j in b]


def test_tables_are_bit_identical():
    ref, port = R.build_tables(), P.build_tables()
    for f in ("config_ids", "num_slices", "slice_slots", "slice_rank", "old_to_new", "watts_by_busy"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (ref.max_slots, ref.penalty_min) == (port.max_slots, port.penalty_min)


@pytest.mark.parametrize("scenario", SCENARIOS5)
def test_batched_jobs_are_bit_identical(scenario):
    _, ref, _ = _ref_inputs(scenario, "static")
    _, port, _ = _port_inputs(scenario, "static")
    for f in ("arrival", "deadline", "work", "rate_by_slots", "valid", "num_jobs", "edf_order"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("policy", ["static", "nomig", "daynight"])
def test_compiled_policies_are_identical(policy):
    ref = R.compile_policy(_ref_policy(policy), R.build_tables(), 4)
    port = P.compile_policy(_port_policy(policy), P.build_tables(), 4)
    assert ref.kind == port.kind
    assert (ref.day_start, ref.day_end) == (port.day_start, port.day_end)
    for f in ("initial", "primary", "secondary"):
        assert np.array_equal(getattr(ref, f), getattr(port, f)), f
    targets, current = np.array([2, 3, 5]), np.array([2, 2, 7])
    ref_h, port_h = R.held_policy(targets, current), P.held_policy(targets, current)
    assert ref_h.kind == port_h.kind == "static"
    for f in ("initial", "primary", "secondary"):
        assert np.array_equal(getattr(ref_h, f), getattr(port_h, f)), f


# ----------------------------------------------------------------------
# single step from a carried state


def _ref_trajectory(policy):
    """Step the reference one grid step at a time through a paper-diurnal
    rollout at load 0.2, yielding ``(t, state before, state after)`` as numpy.

    Calls the reference's jitted one-step chunk with its inputs converted once
    (``run_steps`` would convert them again at every step)."""
    tables, jobs, pol = _ref_inputs("paper-diurnal", policy)
    consts = RB.device_constants(tables, "partial")
    chunk = RB._chunk_fn(pol.kind, RB.DEFAULT_DT_MIN, 1, tables.penalty_min,
                         pol.day_start, pol.day_end)
    inputs = [jnp.asarray(a) for a in (jobs.arrival, jobs.deadline, jobs.rate_by_slots,
                                       jobs.valid, jobs.edf_order, pol.primary, pol.secondary)]
    tabs = [consts[k] for k in ("slice_slots", "slice_rank", "num_slices", "old_to_new", "watts")]
    state = RB.init_state(jobs, pol.initial)
    prev = {k: np.asarray(v) for k, v in state._asdict().items()}
    for i in range(8192):
        t = i * RB.DEFAULT_DT_MIN
        state = chunk(state, *inputs, jnp.float32(t), *tabs)
        post = {k: np.asarray(v) for k, v in state._asdict().items()}
        yield t, prev, post
        prev = post
        if np.isfinite(post["stop_time"]).any():
            return


def _events(tables, prev, post):
    """Which of the step's events happen in some rollout between two states."""
    in_flight = prev["pending"] != prev["cfg"]
    changed = ((prev["remaining"] != post["remaining"]) | (prev["completion"] != post["completion"])).sum(1)
    nsl = tables.num_slices[post["cfg"]]
    return {
        "repartition": bool((in_flight & (prev["stall_left"] <= 1e-6)).any()),
        # more jobs moved than the rollout has slices: a freed slice was handed on
        "handoff": bool(((~in_flight) & (changed > nsl)).any()),
        "ending": bool((~np.isfinite(prev["stop_time"]) & np.isfinite(post["stop_time"])).any()),
    }


@pytest.fixture(scope="module")
def carried_states():
    """For each policy and event, the first reference state whose next step has it.

    The trajectories end at the first rollout's end.  A daynight rollout's
    repartitions are its own (at 5:00 the first finishes); static policies
    never repartition on their own, so their "repartition" state is the state
    of the step with the most jobs running, with ``pending`` set in every
    rollout to the configuration that keeps the most of its slices and the
    stall elapsed: a repartition finishing with jobs to remap and to preempt.
    """
    tables = R.build_tables()
    survivors = (tables.old_to_new >= 0).sum(2)
    np.fill_diagonal(survivors, -1)
    found = {}
    for policy in ("static", "nomig", "daynight"):
        busiest = None
        for t, prev, post in _ref_trajectory(policy):
            for event, hit in _events(tables, prev, post).items():
                if hit and (policy, event) not in found:
                    found[(policy, event)] = (t, prev)
            running = int((prev["slice_job"] >= 0).sum())
            if busiest is None or running > busiest[0]:
                busiest = (running, t, prev)
        if policy != "daynight":
            _, t, prev = busiest
            prev = dict(prev)
            prev["pending"] = survivors.argmax(1)[prev["cfg"]].astype(np.int32)
            prev["stall_left"] = np.zeros_like(prev["stall_left"])
            found[(policy, "repartition")] = (t, prev)
    return found


@pytest.mark.parametrize("event", ["repartition", "handoff", "ending"])
@pytest.mark.parametrize("policy", ["static", "nomig", "daynight"])
def test_one_step_from_a_carried_state(carried_states, policy, event):
    assert (policy, event) in carried_states, f"no {event} in the {policy} rollout"
    t, fields = carried_states[(policy, event)]
    tables, jobs, pol = _ref_inputs("paper-diurnal", policy)
    consts = RB.device_constants(tables, "partial")
    ref_state = RB.RolloutState(*[jnp.asarray(fields[k]) for k in RB.RolloutState._fields])
    ref = RB.run_steps(ref_state, jobs, pol, consts, t0_min=t, n_steps=1,
                       penalty_min=tables.penalty_min)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}

    ptables, pjobs, ppol = _port_inputs("paper-diurnal", policy)
    pconsts = PB.device_constants(ptables, "partial", "cpu")
    port = PB.run_steps(PB.state_from_numpy(fields, "cpu"), pjobs, ppol, pconsts, t0_min=t,
                        n_steps=1, penalty_min=ptables.penalty_min)
    port = PB.state_to_numpy(port)

    for k in PB.RolloutState._fields:
        assert port[k].dtype == ref[k].dtype, k
        if k in ("slice_job", "cfg", "pending", "preemptions", "repartitions"):
            assert np.array_equal(port[k], ref[k]), k
        else:
            np.testing.assert_allclose(port[k], ref[k], rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
    # the step did something: the carried state is not a fixed point
    assert any(not np.array_equal(port[k], fields[k]) for k in PB.RolloutState._fields)


def test_state_round_trip_keeps_values_and_dtypes():
    _, jobs, pol = _port_inputs("paper-diurnal", "daynight", seeds=range(2))
    state = PB.init_state(jobs, pol.initial, "cpu")
    arrays = PB.state_to_numpy(state)
    back = PB.state_from_numpy(arrays, "cpu")
    for k in PB.RolloutState._fields:
        a, b = getattr(state, k), getattr(back, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert {k: v.dtype for k, v in arrays.items()} == {
        k: (np.int32 if k in ("slice_job", "cfg", "pending", "preemptions", "repartitions")
            else np.float32) for k in PB.RolloutState._fields}


# ----------------------------------------------------------------------
# the step's torch-vs-JAX traps, one by one


def test_rank_search_past_the_last_block_needs_no_clamped_index():
    """Fewer in-system jobs than the 2S ranks the EDF search asks for: ranks past
    the last block must read only clipped indices (torch on the CPU raises on any
    out-of-range gather, where JAX would clamp), and agree with the reference."""
    from repro.core.jobs import LINEAR as RLIN, Job as RJob, JobKind as RKind
    from repro_torch.core.jobs import LINEAR as PLIN, Job as PJob, JobKind as PKind

    def jobs_of(Job, Kind, lin):
        return [[Job(i, Kind.TRAINING, 0.1 * i, 30.0, 60.0 + i, lin) for i in range(3)]]

    rt, pt = R.build_tables(), P.build_tables()
    rj = R.BatchedJobs.from_job_lists(jobs_of(RJob, RKind, RLIN), max_slots=rt.max_slots)
    pj = P.BatchedJobs.from_job_lists(jobs_of(PJob, PKind, PLIN), max_slots=pt.max_slots)
    assert pj.padded_jobs == 32  # one block, 3 jobs: 11 of the 14 ranks run past it
    rp = R.compile_policy(RefStatic(12), rt, 1)
    pp = P.compile_policy(StaticPolicy(12), pt, 1)
    ref = R.simulate_batch(rj, rp, tables=rt)
    port = P.simulate_batch(pj, pp, tables=pt, device="cpu")
    assert np.array_equal(np.isfinite(port.completion), np.isfinite(ref.completion))
    np.testing.assert_allclose(port.completion[0, :3], ref.completion[0, :3], atol=MINUTES_ATOL)
    assert port.preemptions[0] == ref.preemptions[0]


def test_set_drop_keeps_live_writes_and_drops_the_sentinel():
    base = torch.full((2, 5), -1, dtype=torch.int64)
    idx = torch.tensor([[4, 0, 4, 2], [1, 4, 4, 4]])  # 4 is the sentinel column
    src = torch.tensor([[7, 8, 9, 10], [11, 12, 13, 14]])
    out = PB._set_drop(base, idx, src)
    assert out.tolist() == [[8, -1, 10, -1], [-1, 11, -1, -1]]


@pytest.mark.parametrize("seed", range(3))
def test_first_hit_is_jnp_argmax_over_a_bool_mask(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((64, 32)) < 0.05  # many rows with no hit, some with several
    mask[0] = False
    expect = np.asarray(jnp.argmax(jnp.asarray(mask), axis=1))
    got = PB._first_hit(torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, expect) and got[0] == 0


@pytest.mark.parametrize("dt", [0.5, 0.25, 60.0 / 7.0, 1.0 / 3.0])
def test_step_time_is_the_reference_float32(dt):
    for t0_steps in (0, 512, 2048):
        t0 = t0_steps * dt
        expect = np.asarray(jnp.float32(t0) + jnp.arange(512, dtype=jnp.int32).astype(jnp.float32)
                            * jnp.float32(dt))
        got = np.array([PB._step_time(t0, i, dt) for i in range(512)], dtype=np.float32)
        assert np.array_equal(got, expect)


def test_time_of_day_is_jnp_mod_at_the_boundaries():
    day = 24 * 60.0
    ts = np.array([k * day + b + d for k in range(4) for b in (0.0, 300.0, 1020.0)
                   for d in (-0.5, -1e-3, 0.0, 1e-3, 0.5)], dtype=np.float32)
    ts = ts[ts >= 0]
    expect = np.asarray(jnp.mod(jnp.asarray(ts), day))
    got = np.array([PB._time_of_day(t) for t in ts], dtype=np.float32)
    assert np.array_equal(got.view(np.int32), expect.view(np.int32))


def test_step_keeps_the_state_dtypes():
    tables, jobs, pol = _port_inputs("paper-diurnal", "daynight", seeds=range(2))
    consts = PB.device_constants(tables, "partial", "cpu")
    state = PB.run_steps(PB.init_state(jobs, pol.initial, "cpu"), jobs, pol, consts,
                         t0_min=0.0, n_steps=700)
    for k in PB.RolloutState._fields:
        want = torch.int32 if k in ("slice_job", "cfg", "pending", "preemptions",
                                    "repartitions") else torch.float32
        assert getattr(state, k).dtype == want, k


# ----------------------------------------------------------------------
# whole rollouts: the agreement matrix, 6 seeds batched per row


def _assert_rollouts_agree(port, ref, label=""):
    for f in ("repartitions", "preemptions", "num_jobs"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f"{label}: {f}"
    finite = np.isfinite(ref.completion)
    assert np.array_equal(np.isfinite(port.completion), finite), f"{label}: completed jobs"
    np.testing.assert_allclose(port.completion[finite], ref.completion[finite], rtol=0,
                               atol=MINUTES_ATOL, err_msg=label)
    np.testing.assert_allclose(port.makespan_min, ref.makespan_min, rtol=0, atol=MINUTES_ATOL,
                               err_msg=label)
    for f in ("energy_wh", "busy_slot_minutes"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=ENERGY_BUSY_RTOL,
                                   err_msg=f"{label}: {f}")
    np.testing.assert_allclose(port.tardiness_integral, ref.tardiness_integral, rtol=TARD_RTOL,
                               atol=TARD_ATOL, err_msg=label)
    np.testing.assert_allclose(port.util_histogram, ref.util_histogram, rtol=0, atol=HIST_ATOL,
                               err_msg=label)


@pytest.mark.parametrize("row", ROWS, ids=ROW_IDS)
def test_whole_rollouts_match_the_reference(reference_results, port_results, row):
    _assert_rollouts_agree(port_results(row), reference_results["/".join(row)], label="/".join(row))


# ----------------------------------------------------------------------
# against the event-driven oracle (BATCHED_SIM.md §4)


def _oracle(jobs, policy, repartition_mode):
    sim = MIGSimulator(make_scheduler("EDF-FS"), repartition_mode=repartition_mode)
    engine = SimulationEngine(sim, policy=policy, jobs=jobs)
    engine.drain()
    return engine.result()


@pytest.mark.parametrize("row", [("paper-diurnal", "daynight", "partial"),
                                 ("bursty-mmpp", "static", "partial")], ids="/".join)
def test_port_agrees_with_the_oracle(port_results, row):
    scenario, policy, mode = row
    for s, b in zip(SEEDS, port_results(row).to_sim_results()):
        o = _oracle(ref_scenario(scenario, seed=s, load_scale=LOAD), _ref_policy(policy), mode)
        label = f"{'/'.join(row)}/seed{s}"
        assert b.num_jobs == o.num_jobs, label
        assert b.repartitions == o.repartitions, label
        assert b.energy_wh == pytest.approx(o.energy_wh, rel=ENERGY_RTOL), label
        d_tard = abs(b.avg_tardiness - o.avg_tardiness)
        assert (d_tard <= TARDINESS_ATOL_MIN
                or d_tard <= TARDINESS_RTOL * max(o.avg_tardiness, TARDINESS_FLOOR)), label
        assert b.busy_slot_minutes == pytest.approx(o.busy_slot_minutes, rel=BUSY_RTOL, abs=1.0), label
        assert abs(b.preemptions - o.preemptions) <= PREEMPTIONS_RTOL * max(
            o.preemptions, PREEMPTIONS_FLOOR), label


# ----------------------------------------------------------------------
# the golden file chip_smoke.py holds the card to


def test_golden_file_is_what_the_reference_gives(reference_results):
    golden = json.loads(GOLDEN.read_text())
    assert (golden["load_scale"], golden["seeds"], golden["dt_min"]) == (
        LOAD, list(SEEDS), R.DEFAULT_DT_MIN)
    assert sorted(golden["rows"]) == sorted(ROW_IDS)
    for rid, res in reference_results.items():
        for f in GOLDEN_FIELDS:
            want, got = np.asarray(golden["rows"][rid][f]), getattr(res, f)
            if f in INT_FIELDS:
                assert np.array_equal(got, want), f"{rid}: {f}"
            else:
                np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL, err_msg=f"{rid}: {f}")


# ----------------------------------------------------------------------
# bad inputs


def test_simulate_batch_rejects_bad_inputs():
    tables, jobs, pol = _port_inputs("paper-diurnal", "static", seeds=range(2))
    with pytest.raises(ValueError, match="must divide 60 minutes"):
        P.simulate_batch(jobs, pol, tables=tables, dt_min=0.7, device="cpu")
    other = P.compile_policy(StaticPolicy(3), tables, 3)
    with pytest.raises(ValueError, match="policy compiled for batch 3, jobs batch 2"):
        P.simulate_batch(jobs, other, tables=tables, device="cpu")
    lists = [port_scenario("paper-diurnal", seed=s, load_scale=LOAD) for s in range(2)]
    odd = P.BatchedJobs.from_job_lists(lists, max_slots=tables.max_slots, pad_multiple=10)
    assert odd.padded_jobs % 32 != 0
    with pytest.raises(ValueError, match=r"padded job axis \d+ must be a multiple of 32"):
        P.simulate_batch(odd, pol, tables=tables, device="cpu")
    with pytest.raises(ValueError, match="unknown repartition_mode"):
        P.simulate_batch(jobs, pol, tables=tables, repartition_mode="fast", device="cpu")


def test_simulate_batch_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    tables, jobs, pol = _port_inputs("paper-diurnal", "static", seeds=range(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.simulate_batch(jobs, pol, tables=tables)


def _write_golden() -> None:
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden_rows(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sim.py --write-golden")
    _write_golden()
