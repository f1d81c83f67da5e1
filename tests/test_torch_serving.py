"""The port's multi-tenant serving workloads (``repro_torch.core.serving``, the
``multi-tenant-serving`` scenario, ``make_scenario_cell``) against the JAX
package's, on the CPU.

Mirrors the reference's single-device tests in tests/test_serving.py, each
held with ``==`` against the reference: the memory-first slice classes and
footprints of all ten configs, the tenant mixes, the generated job streams
(every field of every job), the scenario registry, the jobs' latency and SLO
helpers, the exact merge of tenant stats, and the serving cell's result dict
through ``run_cell`` for each of the four schedulers (integers, tenant counts,
``config_trace`` and ``util_histogram`` exact, floats at rtol 1e-9, the
reference's baseline rule). All of it is float64 host code copied with the
reference's order of operations and numpy draws.

``tests/data/torch_serving_golden.json`` holds the reference's result dicts
of the serving day that ``chip_smoke.py``'s ``serving_day`` phase runs on the
card machine (which has no JAX): the ``balanced`` mix, seed 11, static config
3, a whole day at load 1.0, once per scheduler. Rewrite it (where JAX is) with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_serving.py --write-golden``.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_serving.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

import repro.core.serving as RSV
import repro.sweep.cells as RC
import repro_torch.core.serving as PSV
import repro_torch.sweep.cells as PC
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.core.jobs import LINEAR as REF_LINEAR
from repro.core.jobs import Job as RefJob
from repro.core.jobs import JobKind as RefKind
from repro.core.metrics import TenantSLOStats as RefStats
from repro.core.metrics import merge_tenant_stats as ref_merge
from repro.core.metrics import slo_attainment as ref_attainment
from repro.core.scenarios import generate_scenario as ref_scenario
from repro_torch.configs import ARCH_IDS
from repro_torch.core.jobs import LINEAR, Job, JobKind
from repro_torch.core.metrics import TenantSLOStats, merge_tenant_stats, slo_attainment
from repro_torch.core.scenarios import generate_scenario, scenario_names
from repro_torch.launch.evaluate import _exact_part, values_close

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_serving_golden.json"
SCHEDULERS = ("EDF-FS", "EDF-SS", "LLF", "LALF")
RTOL = 1e-9
BYTES_PER_PARAM = (0.5, 1.0, 2.0)
# the serving day of chip_smoke.py's serving_day phase (the cell of the
# reference's tests/test_serving.py::_serving_cell at a whole day)
DAY_KWARGS = {"horizon_min": 1440.0, "load_scale": 1.0}


def _serving_cell(make, **overrides):
    kw = dict(
        experiment="t", group="g", scheduler="EDF-SS", seed=11,
        scenario="multi-tenant-serving",
        scenario_kwargs={"horizon_min": 240.0, "load_scale": 0.5},
        policy="static", policy_kwargs={"config_id": 3},
    )
    kw.update(overrides)
    return make(**kw)


def day_cell(make, scheduler):
    return _serving_cell(make, scheduler=scheduler, scenario_kwargs=dict(DAY_KWARGS))


def _job_fields(j) -> tuple:
    """Every field of a job, its elasticity by class, label, cap and curve."""
    e = j.elasticity
    return (j.job_id, j.kind.value, j.arrival, j.work, j.deadline, e.klass.value, e.label, e.cap,
            tuple(e.throughput(k) for k in range(1, 8)), j.speedup_no_mig, j.tenant, j.slo_min,
            j.remaining, j.completion, j.preemptions, j.critical_events, j.last_slice)


def _same_result(got, want):
    got, want = dict(got), dict(want)
    got.pop("elapsed_s")
    want.pop("elapsed_s")
    assert values_close(got, want, RTOL), (got, want)
    assert _exact_part(got) == _exact_part(want)
    assert {n: (t["jobs"], t["attained"]) for n, t in got["tenants"].items()} == {
        n: (t["jobs"], t["attained"]) for n, t in want["tenants"].items()}


# ------------------------- model -> slice class ------------------------------


def test_registries_hold_the_references_ten_archs():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("bpp", BYTES_PER_PARAM)
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_model_footprint_and_slice_class_match_the_reference(arch, bpp):
    assert PSV.model_footprint_gb(arch, bpp) == RSV.model_footprint_gb(arch, bpp)
    try:
        want = RSV.model_slice_class(arch, bpp)
    except ValueError as e:
        with pytest.raises(ValueError, match="largest serving class"):
            PSV.model_slice_class(arch, bpp)
        assert "quantize harder" in str(e)
    else:
        assert PSV.model_slice_class(arch, bpp) == want


def test_model_slice_class_is_memory_first():
    assert PSV.model_slice_class("whisper-base", 1.0) == (1, 5)
    assert PSV.model_slice_class("gemma3-1b", 1.0) == (1, 5)
    assert PSV.model_slice_class("gemma3-12b", 1.0) == (4, 20)
    assert PSV.model_slice_class("gemma3-12b", 0.5) == (2, 10)  # int4 halves it
    assert PSV.model_slice_class("mixtral-8x7b", 0.5) == (7, 40)
    with pytest.raises(ValueError):
        PSV.model_slice_class("mixtral-8x7b", 2.0)  # bf16 exceeds the device
    with pytest.raises(ValueError):
        PSV.model_slice_class("nemotron-4-340b", 0.5)  # no class holds 341 B


def test_model_footprint_includes_overhead():
    assert PSV.MEMORY_OVERHEAD == RSV.MEMORY_OVERHEAD
    assert PSV.SLICE_CLASSES == RSV.SLICE_CLASSES
    assert PSV.model_footprint_gb("gemma3-1b", 1.0) > 1.0e9 * 1.0 / 1e9


@pytest.mark.parametrize("slots", [1, 2, 3, 4, 7])
def test_class_elasticity_matches_the_reference(slots):
    got, want = PSV.class_elasticity(slots), RSV.class_elasticity(slots)
    assert (got.klass.value, got.label, got.cap) == (want.klass.value, want.label, want.cap)
    assert [got.throughput(k) for k in range(0, 9)] == [want.throughput(k) for k in range(0, 9)]
    assert PSV.class_elasticity(slots) is got  # memoized: one instance a class


# ------------------------------- the mixes -----------------------------------


def test_serving_mixes_are_well_formed():
    assert set(PSV.SERVING_MIXES) == {"balanced", "small-heavy", "large-heavy"}
    for name, tenants in PSV.SERVING_MIXES.items():
        assert PSV.serving_mix(name) == tenants
        assert len({t.name for t in tenants}) == len(tenants)
        for t in tenants:
            assert t.slice_class in PSV.SLICE_CLASSES
            assert t.demand_slots == t.slice_class[0]
    with pytest.raises(KeyError):
        PSV.serving_mix("nope")


@pytest.mark.parametrize("mix", sorted(RSV.SERVING_MIXES))
def test_serving_mix_matches_the_reference(mix):
    got, want = PSV.serving_mix(mix), RSV.serving_mix(mix)
    assert [dataclasses.astuple(t) for t in got] == [dataclasses.astuple(t) for t in want]
    assert [t.slice_class for t in got] == [t.slice_class for t in want]


# ------------------------------ the job streams ------------------------------


def test_generate_serving_jobs_deterministic_and_tagged():
    jobs = PSV.generate_serving_jobs(7, mix="balanced", horizon_min=360.0)
    again = PSV.generate_serving_jobs(7, mix="balanced", horizon_min=360.0)
    assert jobs == again
    assert jobs != PSV.generate_serving_jobs(8, mix="balanced", horizon_min=360.0)
    assert jobs
    names = {t.name: t for t in PSV.SERVING_MIXES["balanced"]}
    for i, j in enumerate(jobs):
        assert j.job_id == i
        assert j.kind is JobKind.INFERENCE
        assert j.tenant in names
        assert j.slo_min is not None and j.slo_min > 0.0
        assert j.deadline == pytest.approx(j.arrival + j.slo_min)
        assert j.elasticity.cap == names[j.tenant].demand_slots
    arrivals = [j.arrival for j in jobs]
    assert arrivals == sorted(arrivals)


@pytest.mark.parametrize("seed, mix, load_scale, slo_mult, horizon", [
    (7, "balanced", 1.0, 1.0, 360.0),
    (11, "balanced", 1.0, 1.0, 1440.0),
    (3, "small-heavy", 0.5, 1.0, 240.0),
    (0, "large-heavy", 2.0, 1.5, 720.0),
    (5, "small-heavy", 1.3, 0.7, 1440.0),
])
def test_generate_serving_jobs_matches_the_reference_field_by_field(
        seed, mix, load_scale, slo_mult, horizon):
    got = PSV.generate_serving_jobs(seed, mix, load_scale, slo_mult, horizon)
    want = RSV.generate_serving_jobs(seed, mix, load_scale, slo_mult, horizon)
    assert len(got) == len(want) > 0
    assert [_job_fields(j) for j in got] == [_job_fields(j) for j in want]


def test_serving_scenario_registered_and_matches_generator():
    assert "multi-tenant-serving" in scenario_names()
    via_registry = generate_scenario(
        "multi-tenant-serving", 3, mix="small-heavy", horizon_min=240.0
    )
    direct = PSV.generate_serving_jobs(3, mix="small-heavy", horizon_min=240.0)
    assert via_registry == direct
    want = ref_scenario("multi-tenant-serving", 3, mix="small-heavy", horizon_min=240.0)
    assert [_job_fields(j) for j in via_registry] == [_job_fields(j) for j in want]


def test_job_latency_and_slo_attained():
    j = Job(0, JobKind.INFERENCE, arrival=10.0, work=1.0, deadline=15.0,
            elasticity=LINEAR, tenant="t", slo_min=5.0)
    r = RefJob(0, RefKind.INFERENCE, arrival=10.0, work=1.0, deadline=15.0,
               elasticity=REF_LINEAR, tenant="t", slo_min=5.0)
    assert j.latency() == r.latency() == 0.0
    assert not j.slo_attained() and not r.slo_attained()  # incomplete
    for completion in (14.0, 15.0, 15.5):
        j.completion = r.completion = completion
        assert (j.latency(), j.slo_attained()) == (r.latency(), r.slo_attained())
    j.completion = 14.0
    assert j.latency() == pytest.approx(4.0) and j.slo_attained()
    # no SLO declared -> vacuously attained once complete
    free = Job(1, JobKind.INFERENCE, arrival=0.0, work=1.0, deadline=9.0, elasticity=LINEAR)
    free.completion = 99.0
    assert free.slo_attained()


# ----------------------------- tenant accounting -----------------------------


def test_merge_tenant_stats_is_exact():
    a = {"x": TenantSLOStats(jobs=3, attained=2, latency_sum_min=6.0)}
    b = {"x": TenantSLOStats(jobs=1, attained=1, latency_sum_min=2.0),
         "y": TenantSLOStats(jobs=2, attained=0, latency_sum_min=9.0)}
    merged = merge_tenant_stats([a, b])
    assert merged["x"] == TenantSLOStats(jobs=4, attained=3, latency_sum_min=8.0)
    assert merged["y"] == b["y"]
    assert slo_attainment(merged) == pytest.approx(3.0 / 6.0)
    assert slo_attainment({}) == 1.0
    assert merged["x"].attainment == pytest.approx(0.75)
    assert merged["x"].mean_latency_min == pytest.approx(2.0)
    ref = ref_merge([{k: RefStats(**dataclasses.asdict(v)) for k, v in d.items()} for d in (a, b)])
    assert {k: dataclasses.asdict(v) for k, v in merged.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.items()}
    assert slo_attainment(merged) == ref_attainment(ref)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_make_scenario_cell_matches_the_reference(scheduler):
    assert _serving_cell(PC.make_scenario_cell, scheduler=scheduler) == _serving_cell(
        RC.make_scenario_cell, scheduler=scheduler)
    assert day_cell(PC.make_scenario_cell, scheduler) == day_cell(RC.make_scenario_cell, scheduler)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_serving_cell_threads_tenants_through_result_dict(scheduler):
    out = PC.run_cell(_serving_cell(PC.make_scenario_cell, scheduler=scheduler), device="cpu")
    assert "tenants" in out and "slo_attainment" in out
    res = PC.result_to_sim_result(out)
    assert res.tenants
    assert set(res.tenants) <= {t.name for t in PSV.SERVING_MIXES["balanced"]}
    assert 0.0 <= res.slo_attainment <= 1.0
    assert out["slo_attainment"] == pytest.approx(res.slo_attainment)
    for st in res.tenants.values():
        assert isinstance(st, TenantSLOStats)
        assert 0 <= st.attained <= st.jobs
    _same_result(out, RC.run_cell(_serving_cell(RC.make_scenario_cell, scheduler=scheduler)))


def test_non_serving_cell_emits_no_tenant_keys():
    kw = dict(experiment="t", group="g", scheduler="EDF-SS", seed=1, scenario="weekend-flat",
              scenario_kwargs={"horizon_min": 120.0}, policy="static",
              policy_kwargs={"config_id": 3})
    out = PC.run_cell(PC.make_scenario_cell(**kw), device="cpu")
    # absent, not empty: baseline comparison requires exact key equality
    assert "tenants" not in out and "slo_attainment" not in out
    assert PC.result_to_sim_result(out).tenants == {}
    assert PC.result_to_sim_result(out).slo_attainment == 1.0
    want = RC.run_cell(RC.make_scenario_cell(**kw))
    out.pop("elapsed_s"), want.pop("elapsed_s")
    assert values_close(out, want, RTOL) and _exact_part(out) == _exact_part(want)


def test_golden_file_holds_the_references_serving_day():
    """The golden file is the reference's day; the port's EDF-FS day (the
    quickest of the four; chip_smoke.py runs all four) equals it."""
    golden = json.loads(GOLDEN.read_text())
    assert set(golden) == set(SCHEDULERS)
    assert all(golden[s]["cell"] == day_cell(PC.make_scenario_cell, s) for s in SCHEDULERS)
    out = PC.run_cell(day_cell(PC.make_scenario_cell, "EDF-FS"), device="cpu")
    _same_result(out, {**golden["EDF-FS"]["result"], "elapsed_s": 0.0})


def _write_golden() -> None:
    days = {}
    for s in SCHEDULERS:
        cell = day_cell(RC.make_scenario_cell, s)
        result = RC.run_cell(cell)
        result.pop("elapsed_s")
        days[s] = {"cell": cell, "result": result}
    GOLDEN.write_text(json.dumps(days, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu "
                 "python tests/test_torch_serving.py --write-golden")
    _write_golden()
