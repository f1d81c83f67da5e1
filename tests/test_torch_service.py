"""The port's scheduler service (``repro_torch.service``) against the JAX package's ``repro.service``, on the CPU.

Mirrors the reference's tests/test_service.py, each case held against the
reference: the job codec both ways (a dict either package encodes decodes
in the other to the same job), the WAL records and files (a log written by
either reads in the other), the checkpoint store and the replay clock; the
engine's service ops (``cancel``, ``reconfigure``, pickle snapshots,
``harvest_completed``, ``job_disposition``) and its error messages; the
service's ops, their error types and messages, and its results with ``==``
on :class:`SimResult` (single device, fleet mode, through checkpoints and
recovery); the socket front end and the CLI; and the interleaving property
(random op scripts, perturbed by partial advances, snapshots and pickle
round trips, against the reference's unperturbed application: results,
``config_trace`` and every op's outcome or error type).

``tests/data/torch_service_golden.json`` holds the reference's results of
``chip_smoke.py``'s ``service`` and ``cluster_day`` phases; its inputs and
comparisons live in ``tests/torch_service_golden.py``. Rewrite it (where JAX
is) with ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_service.py --write-golden``.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_service.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pickle
import random
import sys
import tempfile
import threading
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.jobs as RJ
import repro.core.scenarios as RSC
import repro.core.simulator as RSIM
import repro.distributed.fault_tolerance as RFT
import repro.launch.cluster_sim as RCS
import repro.service as RSV
import repro_torch.core.jobs as PJ
import repro_torch.core.scenarios as PSC
import repro_torch.core.simulator as PSIM
import repro_torch.distributed.fault_tolerance as PFT
import repro_torch.launch.cluster_sim as PCS
import repro_torch.service as PSV
from repro.core.engine import SimulationEngine as RefEngine
from repro.core.schedulers import make_scheduler as ref_scheduler
from repro.fleet.simulator import FleetSimulator as RefFleet
from repro.fleet.simulator import FleetSpec as RefFleetSpec
from repro_torch.core.engine import SimulationEngine
from repro_torch.core.schedulers import make_scheduler
from repro_torch.fleet.simulator import FleetSimulator, FleetSpec

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_service_golden as G  # noqa: E402

SCHEDULERS = ("EDF-FS", "EDF-SS", "LLF", "LALF")


def _ref_dqn(params):
    from repro.core.rl import DQNConfig, DQNLearner, greedy_policy
    from repro.core.rl.env import FEATURE_DIM

    def factory():
        learner = DQNLearner(DQNConfig(state_dim=FEATURE_DIM))
        learner.load(params)
        return greedy_policy(learner)

    return factory


REF = G.package_from(RSV, RSC, RCS, RSIM, RFT, _ref_dqn)
PORT = G.package_from(PSV, PSC, PCS, PSIM, PFT,
                      lambda params: PCS.day_policy_factory("dynamic", params, "cpu"))
# (package, jobs, simulator, engine, scheduler factory) of each side
SIDES = {
    "ref": (RSV, RJ, RSIM, RefEngine, ref_scheduler, RefFleet, RefFleetSpec),
    "port": (PSV, PJ, PSIM, SimulationEngine, make_scheduler, FleetSimulator, FleetSpec),
}


def _res(r) -> dict:
    return dataclasses.asdict(r)


def J(jobs_mod, jid, arrival, work=10.0, slack=60.0, kind="inference", elast="linear"):
    return jobs_mod.Job(job_id=jid, kind=jobs_mod.JobKind(kind), arrival=arrival, work=work,
                        deadline=arrival + slack, elasticity=jobs_mod.elasticity_from_label(elast))


def _stream_engine(side, scheduler="EDF-SS", policy=None, **sim_kw):
    _, _, simm, engine, sched, _, _ = SIDES[side]
    sim = simm.MIGSimulator(sched(scheduler), **sim_kw)
    return engine(sim, policy=policy or simm.StaticPolicy(3), stream_open=True)


def _both(fn):
    """``fn(side)`` for the reference and the port."""
    return fn("ref"), fn("port")


def _err(fn):
    """The exception ``fn`` raises, as (type name, message), or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# codecs


def _codec_jobs(jm):
    return [
        J(jm, 0, 0.1 + 0.2, work=1.0 / 3.0, elast="capped@2g"),
        J(jm, 7, 123.456789, elast="log-0.65", kind="training"),
        jm.Job(job_id=3, kind=jm.JobKind.INFERENCE, arrival=5.5, work=2.0, deadline=9.25,
               elasticity=jm.elasticity_from_label("capped@7g"), speedup_no_mig=1.06, tenant="acme",
               slo_min=4.5),
        J(jm, 11, 17.000000001, work=math.pi, elast="exp-0.35"),
    ]


def test_job_codec_round_trips_and_matches_reference_both_ways():
    ref, port = _codec_jobs(RJ), _codec_jobs(PJ)
    for rj, pj in zip(ref, port):
        d = PSV.job_to_dict(pj)
        assert d == RSV.job_to_dict(rj)
        assert list(d) == list(RSV.job_to_dict(rj))
        for back in (PSV.job_from_dict(d), PSV.job_from_dict(RSV.job_to_dict(rj)),
                     PSV.job_from_dict(json.loads(json.dumps(d)))):
            assert PSV.job_to_dict(back) == d
            assert back.elasticity.label == pj.elasticity.label
            for k in (0.5, 1.0, 3.3, 7.0):
                assert back.elasticity.throughput(k) == pj.elasticity.throughput(k)
            assert (back.job_id, back.arrival, back.work, back.deadline, back.speedup_no_mig,
                    back.tenant, back.slo_min) == (pj.job_id, pj.arrival, pj.work, pj.deadline,
                                                   pj.speedup_no_mig, pj.tenant, pj.slo_min)
        # the port's dict decodes in the reference to the same job
        assert RSV.job_to_dict(RSV.job_from_dict(d)) == d


@pytest.mark.parametrize("label", ["linear", "capped@1g", "capped@2g", "capped@3g", "capped@4g",
                                   "capped@7g", "exp-0.35", "exp-0.60", "log-0.65", "log-0.45"])
def test_elasticity_from_label_and_pickling_match_reference(label):
    got, want = PJ.elasticity_from_label(label), RJ.elasticity_from_label(label)
    assert (got.klass.value, got.label, got.cap) == (want.klass.value, want.label, want.cap)
    for k in (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 5.5, 7.0):
        assert got.throughput(k) == want.throughput(k)
    back = pickle.loads(pickle.dumps(got))
    assert back.label == label and back.throughput(3.0) == got.throughput(3.0)
    job = pickle.loads(pickle.dumps(J(PJ, 1, 2.0, elast=label)))
    assert job.elasticity.label == label


def test_elasticity_label_errors_match_reference():
    for label in ("superlinear", "capped@0g", "capped@g"):
        assert _err(lambda: PJ.elasticity_from_label(label)) == _err(
            lambda: RJ.elasticity_from_label(label))
    curve = PJ.Elasticity(PJ.ElasticityClass.SUBLINEAR, "gemma3-1b:decode_32k", lambda k: k)
    ref_curve = RJ.Elasticity(RJ.ElasticityClass.SUBLINEAR, "gemma3-1b:decode_32k", lambda k: k)
    assert _err(lambda: pickle.dumps(curve)) == _err(lambda: pickle.dumps(ref_curve))
    assert _err(lambda: pickle.dumps(curve))[0] == "ValueError"
    assert PJ.sublinear("exp-0.60") is PJ.SUBLINEAR_CURVES["exp-0.60"]


@pytest.mark.parametrize("rec", [
    {"seq": 1, "t": 0.0, "op": "explode"},
    {"op": "close", "t": 0.0},
    {"seq": 2, "t": 1.0, "op": "submit"},
    {"seq": 2, "op": "close"},
    {"seq": 3, "t": 1.0, "op": "cancel"},
    {"seq": 4, "t": 1.0, "op": "reconfigure", "config": 6},
    {"seq": 5, "t": 2, "op": "close"},
])
def test_validate_record_matches_reference(rec):
    assert _err(lambda: PSV.validate_record(rec)) == _err(lambda: RSV.validate_record(rec))
    assert PSV.WAL_FORMAT == RSV.WAL_FORMAT == 1
    assert dict(PSV.records.WAL_OPS) == dict(RSV.records.WAL_OPS)


# ---------------------------------------------------------------------------
# WAL


def _wal_records(jm, sv):
    return [
        {"seq": 1, "op": "submit", "t": 0.5, "job": sv.job_to_dict(J(jm, 0, 0.5))},
        {"seq": 2, "op": "cancel", "t": 1.5, "job_id": 0},
        {"seq": 3, "op": "reconfigure", "t": 1.75, "config": 6, "device": 0},
        {"seq": 4, "op": "close", "t": 2.0},
    ]


def test_wal_files_are_byte_identical_and_read_in_either_package(tmp_path):
    paths = {}
    for side, (sv, jm, *_rest) in SIDES.items():
        paths[side] = tmp_path / f"{side}.jsonl"
        wal = sv.WriteAheadLog(paths[side])
        for r in _wal_records(jm, sv):
            wal.append(r)
        wal.close()
    assert paths["ref"].read_bytes() == paths["port"].read_bytes()
    want = _wal_records(RJ, RSV)
    assert PSV.read_wal(paths["ref"]) == RSV.read_wal(paths["port"]) == want
    assert PSV.read_wal(tmp_path / "missing.jsonl") == []


def test_wal_torn_tail_and_mid_file_corruption_match_reference(tmp_path):
    path = tmp_path / "wal.jsonl"
    wal = PSV.WriteAheadLog(path)
    wal.append({"seq": 1, "op": "close", "t": 0.0})
    wal.append({"seq": 2, "op": "close", "t": 1.0})
    wal.close()
    with open(path, "a") as fh:
        fh.write('{"seq": 3, "op": "clo')
    assert [r["seq"] for r in PSV.read_wal(path)] == [1, 2] == [r["seq"] for r in RSV.read_wal(path)]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"seq": 1, "op": "close", "t": 0.0}\nGARBAGE\n{"seq": 2, "op": "close", "t": 1.0}\n')
    got, want = _err(lambda: PSV.read_wal(bad)), _err(lambda: RSV.read_wal(bad))
    assert got == want and "corrupted at line 2" in got[1]


def test_wal_rotate_truncates_and_appends_continue(tmp_path):
    for side, (sv, *_rest) in SIDES.items():
        path = tmp_path / f"{side}.jsonl"
        wal = sv.WriteAheadLog(path)
        for seq in (1, 2, 3):
            wal.append({"seq": seq, "op": "close", "t": float(seq)})
        wal.rotate(())
        assert wal.size_bytes() == 0
        wal.rotate([{"seq": 9, "op": "close", "t": 9.0}])
        wal.append({"seq": 10, "op": "close", "t": 10.0})
        wal.close()
        assert [r["seq"] for r in sv.read_wal(path)] == [9, 10]
    assert (tmp_path / "ref.jsonl").read_bytes() == (tmp_path / "port.jsonl").read_bytes()


# ---------------------------------------------------------------------------
# checkpoint store, replay clock


def test_checkpoint_store_rotation_matches_reference(tmp_path):
    names = {}
    for side, (sv, *_rest) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        store = sv.CheckpointStore(d, keep=2)
        assert store.latest() is None
        for seq in (3, 7, 12):
            store.save(f"blob-{seq}".encode(), seq)
        assert store.latest() == (12, b"blob-12")
        names[side] = sorted(p.name for p in d.iterdir())
        assert _err(lambda: sv.CheckpointStore(d, keep=0))[0] == "ValueError"
    assert names["port"] == names["ref"] == ["ckpt-000000000007.pkl", "ckpt-000000000012.pkl"]


def test_replay_clock_paced_free_and_resync_match_reference():
    for sv in (RSV, PSV):
        wall = [100.0]
        clock = sv.ReplayClock(speedup=120.0, time_source=lambda: wall[0])
        assert clock.paced and clock.now() == 0.0
        wall[0] += 30.0
        assert clock.now() == pytest.approx(60.0)
        assert clock.wall_seconds_until(90.0) == pytest.approx(15.0)
        clock.resync(10.0)
        assert clock.now() == 10.0
        free = sv.ReplayClock.free()
        assert not free.paced and free.now() == 0.0 and free.wall_seconds_until(1e9) == 0.0
    assert _err(lambda: PSV.ReplayClock(speedup=-1.0)) == _err(lambda: RSV.ReplayClock(speedup=-1.0))


# ---------------------------------------------------------------------------
# engine: inject errors, cancellation, reconfiguration


def _inject_errors(side):
    jm = SIDES[side][1]
    out = []
    eng = _stream_engine(side)
    eng.inject(J(jm, 5, 1.0))
    out.append(_err(lambda: eng.inject(J(jm, 5, 2.0))))
    eng2 = _stream_engine(side)
    eng2.close_stream()
    out.append(_err(lambda: eng2.inject(J(jm, 0, 1.0))))
    eng3 = _stream_engine(side)
    eng3.inject(J(jm, 0, 1.0))
    eng3.run_until(50.0)
    out.append(_err(lambda: eng3.inject(J(jm, 1, 10.0))))
    return out


def test_inject_errors_name_time_id_remedy_as_reference():
    want, got = _both(_inject_errors)
    assert got == want
    assert "unique id" in got[0][1] and "stream_open=True" in got[1][1] and "re-stamp" in got[2][1]


def _cancel_dispositions(side):
    jm, simm = SIDES[side][1], SIDES[side][2]
    eng = _stream_engine(side, policy=simm.StaticPolicy(2))
    sim = eng.sim
    for jid in (0, 1, 2):
        eng.inject(J(jm, jid, 0.0, work=50.0))
    eng.inject(J(jm, 3, 500.0))
    eng.run_until(1.0)
    out = [len(sim.assignment), sim.preemptions]
    running = next(iter(sim.assignment))
    out += [eng.cancel(running), sim.preemptions, sim.active.get(running)]
    eng.inject(J(jm, 4, sim.t + 0.5, work=50.0))
    eng.run_until(sim.t + 1.0)
    queued = [j for j in sim.active if j not in sim.assignment]
    out += [queued, eng.cancel(queued[0]), eng.cancel(3)]
    eng.close_stream()
    eng.drain()
    return out, _res(eng.result()), len(sim.cancelled), list(sim.config_trace)


def test_cancel_dispositions_and_charging_match_reference():
    want, got = _both(_cancel_dispositions)
    assert got == want
    assert got[0][2] == "preempted" and got[0][-2:] == ["dequeued", "unarrived"]
    assert got[1]["extra"]["cancelled_jobs"] == 3.0 and got[1]["num_jobs"] == 2


def _cancel_unarrived(side):
    jm, simm = SIDES[side][1], SIDES[side][2]
    eng = _stream_engine(side, policy=simm.DayNightPolicy())
    eng.inject(J(jm, 0, 10.0, work=1.0))
    eng.inject(J(jm, 1, 20.0, work=1.0))
    eng.cancel(1)
    eng.close_stream()
    events = []
    while (ev := eng.step()) is not None:
        events.append((ev.t, ev.kind.name, ev.job_id))
    return events, _res(eng.result())


def test_cancel_unarrived_event_is_skipped_as_reference():
    want, got = _both(_cancel_unarrived)
    assert got == want
    assert all(job_id != 1 for _, _, job_id in got[0]) and got[1]["num_jobs"] == 1


def _cancel_errors(side):
    jm = SIDES[side][1]
    eng = _stream_engine(side)
    out = [_err(lambda: eng.cancel(42))]
    eng.inject(J(jm, 0, 0.0, work=1.0))
    eng.run_until(10.0)
    out.append(_err(lambda: eng.cancel(0)))
    eng.inject(J(jm, 1, eng.sim.t + 1.0))
    eng.cancel(1)
    out.append(_err(lambda: eng.cancel(1)))
    # a running job cancelled: the survivor completes as in the reference
    eng2 = _stream_engine(side, policy=SIDES[side][2].StaticPolicy(2))
    eng2.inject(J(jm, 0, 0.0, work=8.0))
    eng2.inject(J(jm, 1, 0.0, work=6.0))
    eng2.run_until(0.5)
    eng2.cancel(0)
    eng2.close_stream()
    eng2.drain()
    return out, _res(eng2.result()), eng2.sim.active


def test_cancel_errors_and_survivors_match_reference():
    want, got = _both(_cancel_errors)
    assert got == want
    assert "never injected" in got[0][0][1] and "already completed at t=" in got[0][1][1]
    assert "already cancelled" in got[0][2][1] and got[1]["num_jobs"] == 1 and got[2] == {}


def _reconfigure(side):
    jm, simm = SIDES[side][1], SIDES[side][2]
    eng = _stream_engine(side, policy=simm.StaticPolicy(3))
    eng.inject(J(jm, 0, 0.0, work=30.0))
    eng.run_until(1.0)
    out = [eng.reconfigure(3), _err(lambda: eng.reconfigure(999)), eng.reconfigure(6),
           _err(lambda: eng.reconfigure(2))]
    eng.close_stream()
    eng.drain()
    return out, eng.sim.partition.config_id, eng.sim.repartitions, _res(eng.result())


def test_reconfigure_manual_switch_and_errors_match_reference():
    want, got = _both(_reconfigure)
    assert got == want
    assert got[0][0] is False and got[0][2] is True and got[1] == 6 and got[2] == 1
    assert "not in this" in got[0][1][1] and "in flight until" in got[0][3][1]


# ---------------------------------------------------------------------------
# engine: pickle snapshots, harvest, disposition


def _half_run_engine(side, scheduler="EDF-SS"):
    _, _, simm, engine, sched, _, _ = SIDES[side]
    scen = RSC if side == "ref" else PSC
    jobs = scen.generate_scenario("trace-scaled", seed=3, horizon_min=240.0)
    eng = engine(simm.MIGSimulator(sched(scheduler)), policy=simm.DayNightPolicy(), jobs=jobs)
    eng.run_until(120.0)
    return eng


def _ref_oracle(horizon_min=240.0, seed=3):
    return _res(RSIM.MIGSimulator(ref_scheduler("EDF-SS")).run(
        RSC.generate_scenario("trace-scaled", seed=seed, horizon_min=horizon_min),
        policy=RSIM.DayNightPolicy()))


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_pickle_snapshot_resumes_bit_identically_to_reference(scheduler):
    eng = _half_run_engine("port", scheduler)
    restored = SimulationEngine.from_snapshot_bytes(eng.to_snapshot_bytes())
    eng.drain()
    restored.drain()
    ref = _half_run_engine("ref", scheduler)
    ref.drain()
    assert _res(restored.result()) == _res(eng.result()) == _res(ref.result())
    assert restored.sim.config_trace == eng.sim.config_trace == ref.sim.config_trace


def test_snapshot_reattaches_observers_and_type_checks():
    eng = _half_run_engine("port")
    seen = []
    restored = SimulationEngine.from_snapshot_bytes(eng.to_snapshot_bytes(), trace_sink=seen.append)
    restored.drain()
    assert seen and restored.trace_sink is not None
    got = _err(lambda: SimulationEngine.from_snapshot_bytes(pickle.dumps({"not": "engine"})))
    want = _err(lambda: RefEngine.from_snapshot_bytes(pickle.dumps({"not": "engine"})))
    assert got == want and "not a SimulationEngine" in got[1]
    assert _res(restored.result()) == _ref_oracle()


def test_snapshot_unpicklable_policy_raises_actionable():
    sim = PSIM.MIGSimulator(make_scheduler("EDF-SS"))
    eng = SimulationEngine(sim, policy=PSIM.CallbackPolicy(lambda t, s: None), stream_open=True)
    got = _err(eng.to_snapshot_bytes)
    assert got[0] == "ValueError" and "make_policy" in got[1] and "repro_torch.service" in got[1]


def test_harvest_bounds_memory_and_result_refuses_as_reference():
    eng = _half_run_engine("port")
    sim = eng.sim
    n_before = len(sim.completed)
    assert n_before > 0
    stats = PSV.ServiceStats()
    stats.fold(*eng.harvest_completed())
    assert sim.completed == [] and stats.num_completed == n_before
    eng.drain()
    stats.fold(*eng.harvest_completed())
    got = _err(eng.result)
    assert got[0] == "RuntimeError" and "harvest_completed" in got[1]
    assert _res(stats.result(sim)) == _ref_oracle()
    assert [f.name for f in dataclasses.fields(PSV.ServiceStats)] == [
        f.name for f in dataclasses.fields(RSV.ServiceStats)]


def _disposition(side):
    jm, simm = SIDES[side][1], SIDES[side][2]
    eng = _stream_engine(side, policy=simm.StaticPolicy(2))
    out = [eng.job_disposition(0)]
    eng.inject(J(jm, 0, 5.0, work=30.0))
    out.append(eng.job_disposition(0))
    eng.run_until(6.0)
    out.append(eng.job_disposition(0))
    for jid in (1, 2, 3):
        eng.inject(J(jm, jid, 6.5, work=50.0))
    eng.run_until(7.0)
    out.append([eng.job_disposition(j) for j in (1, 2, 3)])
    eng.cancel(3)
    out.append(eng.job_disposition(3))
    eng.run_until(500.0)
    out += [eng.job_disposition(0), eng.job_disposition(3)]
    return out


def test_job_disposition_lifecycle_matches_reference():
    want, got = _both(_disposition)
    assert got == want
    assert got[:3] == [None, "pending", "running"] and "queued" in got[3]
    assert got[4:] == ["cancelled", "completed", "cancelled"]


# ---------------------------------------------------------------------------
# the policy registry, the config


@pytest.mark.parametrize("spec", ["static", "static:2", "daynight", "daynight:6,2", "nomig",
                                  "heuristic", "forecast"])
def test_make_policy_registry_matches_reference(spec):
    got, want = PSV.make_policy(spec), RSV.make_policy(spec)
    assert type(got).__name__ == type(want).__name__
    assert got.initial_config == want.initial_config
    for attr in ("config_id", "day_config", "night_config", "repartition_mode"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    assert PSV.make_policy(spec) is not got  # a fresh instance per call
    assert pickle.loads(pickle.dumps(got)).initial_config == got.initial_config
    assert PSV.POLICY_SPECS == RSV.POLICY_SPECS


def test_make_policy_unknown_spec_matches_reference():
    got, want = _err(lambda: PSV.make_policy("dqn")), _err(lambda: RSV.make_policy("dqn"))
    assert got == want and "unknown policy spec" in got[1]


def test_service_config_round_trip_and_unknown_key_match_reference():
    cfg = PSV.ServiceConfig(policy="static:2", fleet_profiles=("a100-250w",))
    ref = RSV.ServiceConfig(policy="static:2", fleet_profiles=("a100-250w",))
    assert cfg.to_dict() == ref.to_dict()
    assert PSV.ServiceConfig.from_dict(ref.to_dict()) == cfg
    assert PSV.ServiceConfig().to_dict() == RSV.ServiceConfig().to_dict()
    assert _err(lambda: PSV.ServiceConfig.from_dict({"warp_drive": True})) == _err(
        lambda: RSV.ServiceConfig.from_dict({"warp_drive": True}))


# ---------------------------------------------------------------------------
# the service, single device


def _one_shot(side, workdir):
    sv, scen = (RSV, RSC) if side == "ref" else (PSV, PSC)
    jobs = scen.generate_scenario("trace-scaled", seed=3, horizon_min=360.0)
    svc = sv.SchedulerService(workdir, sv.ServiceConfig(policy="daynight", checkpoint_every_min=60.0))
    for j in jobs:
        svc.submit(j)
    svc.close()
    res = _res(svc.result())
    svc.shutdown()
    header = (workdir / "service.json").read_text()
    ckpts = sorted(p.name for p in workdir.glob("ckpt-*.pkl"))
    again = sv.SchedulerService(workdir)
    return res, header, ckpts, again.closed, _res(again.result())


def test_service_one_shot_equals_reference_through_checkpoints(tmp_path):
    want = _one_shot("ref", tmp_path / "ref")
    got = _one_shot("port", tmp_path / "port")
    assert got == want
    assert got[0] == _ref_oracle(360.0) and 1 <= len(got[2]) <= 2 and got[3]


def _submit_validation(side, workdir):
    sv, jm = SIDES[side][0], SIDES[side][1]
    svc = sv.SchedulerService(workdir, sv.ServiceConfig(policy="static"))
    out = [svc.submit(J(jm, 0, 10.0)), _err(lambda: svc.submit(J(jm, 0, 11.0))),
           _err(lambda: svc.submit(J(jm, 1, 5.0))), svc.submit(J(jm, 1, 5.0, slack=60.0), restamp=True),
           svc.job_status(1)]
    svc.close()
    out.append(_err(lambda: svc.submit(J(jm, 2, 99.0))))
    out.append(_res(svc.result()))
    svc.shutdown()
    return out


def test_service_submit_validation_matches_reference(tmp_path):
    want = _submit_validation("ref", tmp_path / "ref")
    got = _submit_validation("port", tmp_path / "port")
    assert got == want
    assert "already submitted" in got[1][1] and "restamp=True" in got[2][1]
    assert got[3]["state"] == "submitted" and "closed" in got[5][1]


def _cancel_validation(side, workdir):
    sv, jm = SIDES[side][0], SIDES[side][1]
    svc = sv.SchedulerService(workdir, sv.ServiceConfig(policy="static", checkpoint_every_min=0.0))
    out = [_err(lambda: svc.cancel(9))]
    svc.submit(J(jm, 0, 0.0, work=1.0))
    out.append(svc.tick())
    svc.submit(J(jm, 1, 30.0, work=1.0))
    svc.checkpoint()
    out += [_err(lambda: svc.cancel(0)), svc.cancel(1), _err(lambda: svc.cancel(1)),
            svc.job_status(0), svc.job_status(1)]
    svc.close()
    out.append(_res(svc.result()))
    svc.shutdown()
    return out


def test_service_cancel_validation_messages_match_reference(tmp_path):
    want = _cancel_validation("ref", tmp_path / "ref")
    got = _cancel_validation("port", tmp_path / "port")
    assert got == want
    assert "never submitted" in got[0][1] and "terminal state 'completed'" in got[2][1]
    assert "terminal state 'cancelled'" in got[4][1]


def _status(side, workdir):
    sv, jm = SIDES[side][0], SIDES[side][1]
    svc = sv.SchedulerService(workdir, sv.ServiceConfig(policy="static"))
    svc.submit(J(jm, 0, 0.0, work=500.0))
    out = [_err(svc.result)]
    svc.submit(J(jm, 1, 1.0, work=500.0))
    out += [svc.status(), svc.status(job_id=0), svc.job_status(77)]
    svc.close()
    out += [svc.status(), _res(svc.result())]
    svc.shutdown()
    return out


def test_service_status_and_result_requires_close_match_reference(tmp_path):
    want = _status("ref", tmp_path / "ref")
    got = _status("port", tmp_path / "port")
    assert got == want
    assert got[0][0] == "RuntimeError" and "close" in got[0][1]
    assert got[1]["submitted"] == 2 and got[1]["devices"] == 1 and got[3]["state"] == "unknown"


def test_service_config_mismatch_refused_as_reference(tmp_path):
    for side, (sv, *_rest) in SIDES.items():
        sv.SchedulerService(tmp_path / side, sv.ServiceConfig(policy="static")).shutdown()
    got = _err(lambda: PSV.SchedulerService(tmp_path / "port", PSV.ServiceConfig(policy="daynight")))
    want = _err(lambda: RSV.SchedulerService(tmp_path / "ref", RSV.ServiceConfig(policy="daynight")))
    assert got[0] == want[0] == "ValueError" and "different config" in got[1]
    got = _err(lambda: PSV.SchedulerService.recover(tmp_path / "nowhere"))
    assert got == _err(lambda: RSV.SchedulerService.recover(tmp_path / "nowhere"))
    assert got[0] == "FileNotFoundError" and "nothing to recover" in got[1]


def test_service_headers_and_wals_are_byte_identical_to_reference(tmp_path):
    files = {}
    for side, (sv, *_rest) in SIDES.items():
        pkg = REF if side == "ref" else PORT
        cfg = sv.ServiceConfig(policy="heuristic", repartition_mode="drain", checkpoint_every_min=0.0)
        svc = sv.SchedulerService(tmp_path / side, cfg)
        G.drive(svc, G.script(pkg, 5, n=60))
        svc.wal.close()
        files[side] = [(tmp_path / side / name).read_bytes() for name in ("service.json", "wal.jsonl")]
    assert files["port"] == files["ref"]
    assert files["port"][1].count(b"\n") > 60


# ---------------------------------------------------------------------------
# fleet stream


def _fleet(side, interleave):
    sv, _, _, _, _, fleet_cls, spec_cls = SIDES[side]
    scen = RSC if side == "ref" else PSC
    jobs = scen.generate_scenario("trace-scaled", seed=9, horizon_min=300.0)
    fleet = fleet_cls(spec_cls.of(("a100-250w", "a30-165w"), dispatcher="least-loaded"))
    if not interleave:
        fr = fleet.run(jobs, lambda i, p: sv.make_policy("daynight"))
    else:
        stream = fleet.open_stream(lambda i, p: sv.make_policy("daynight"))
        for k, job in enumerate(jobs):
            if k % 7 == 3:
                stream.run_until(job.arrival)
            stream.submit(job)
        stream.close()
        fr = stream.result()
    return G.fleet_dict(fr)


def test_fleet_stream_bit_identical_to_batch_and_reference():
    want = _fleet("ref", False)
    assert _fleet("port", True) == _fleet("port", False) == want


def _fleet_cancel(side):
    sv, jm, _, _, _, fleet_cls, spec_cls = SIDES[side]
    fleet = fleet_cls(spec_cls.of(("a100-250w", "a100-250w"), dispatcher="round-robin"))
    stream = fleet.open_stream(lambda i, p: sv.make_policy("static"))
    stream.submit(J(jm, 0, 0.0, work=200.0))
    stream.submit(J(jm, 1, 0.0, work=200.0))
    out = [_err(lambda: stream.cancel(5)), stream.cancel(1)]
    stream.close()
    out += [G.fleet_dict(stream.result()), _err(lambda: stream.submit(J(jm, 2, 1.0)))]
    return out


def test_fleet_stream_cancel_routing_matches_reference():
    want, got = _both(_fleet_cancel)
    assert got == want
    assert "never dispatched" in got[0][1] and got[2]["aggregate"]["num_jobs"] == 1
    assert "closed" in got[3][1]


def test_fleet_stream_pickles_whole():
    fleet = FleetSimulator(FleetSpec.of(("a100-250w", "a30-165w"), dispatcher="state-aware"))
    stream = fleet.open_stream(lambda i, p: PSV.make_policy("daynight"))
    jobs = PSC.generate_scenario("trace-scaled", seed=9, horizon_min=240.0)
    half = len(jobs) // 2
    for job in jobs[:half]:
        stream.submit(job)
    restored = pickle.loads(pickle.dumps(stream))
    for s in (stream, restored):
        for job in PSC.generate_scenario("trace-scaled", seed=9, horizon_min=240.0)[half:]:
            s.submit(job)
        s.close()
    assert G.fleet_dict(restored.result()) == G.fleet_dict(stream.result())
    assert restored.owner == stream.owner and restored.counts == stream.counts


def test_service_fleet_mode_checkpoint_recovery_matches_reference(tmp_path):
    want = G.fleet_oracle(REF, tmp_path / "ref")
    assert G.fleet_recovered(PORT, tmp_path / "port") == want
    svc = PSV.SchedulerService(tmp_path / "port")
    assert svc.closed and G.as_dict(svc.result()) == want["aggregate"]
    with pytest.raises(RuntimeError, match="single device"):
        PSV.SchedulerService(tmp_path / "one", PSV.ServiceConfig()).fleet_result()


# ---------------------------------------------------------------------------
# the socket front end and the CLI


def test_server_round_trip_over_unix_socket_matches_reference(tmp_path):
    sock = tmp_path / "svc.sock"
    svc = PSV.SchedulerService(tmp_path / "svc", G.socket_config(PORT))
    server = PSV.ServiceServer(svc, sock, tick_interval_s=0.01)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        PSV.wait_for_socket(sock, timeout_s=10.0)
        client = PSV.ServiceClient(sock)
        out = G.socket_script(client)
        client.shutdown()
        client.close()
    finally:
        thread.join(timeout=10)
    assert not thread.is_alive() and not sock.exists()
    assert all(out["checks"].values()), out["checks"]
    assert out["result"] == G.socket_oracle(REF, tmp_path / "ref")
    svc2 = PSV.SchedulerService(tmp_path / "svc")
    assert svc2.closed and PSV.sim_result_to_dict(svc2.result()) == out["result"]
    assert PSV.ServiceServer(svc2, sock).handle({"cmd": "warp"}) == RSV.ServiceServer(
        svc2, sock).handle({"cmd": "warp"})


def test_cli_replay_resume_and_flags_match_reference(tmp_path, capsys):
    from repro.service.__main__ import main as ref_main
    from repro_torch.service.__main__ import main

    outs = {}
    for side, fn in (("ref", ref_main), ("port", main)):
        argv = ["replay", "--dir", str(tmp_path / side), "--scenario", "trace-scaled", "--seed", "7",
                "--max-jobs", "40", "--policy", "daynight"]
        assert fn(argv) == 0
        first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert fn(argv) == 0
        second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs[side] = (first, second)
    first, second = outs["port"]
    assert outs["port"] == outs["ref"]
    assert first["fed"] == 40 and first["skipped"] == 0
    assert second["fed"] == 0 and second["skipped"] == 40 and second["result"] == first["result"]


# ---------------------------------------------------------------------------
# property: random op interleavings vs the reference's unperturbed run


@st.composite
def op_scripts(draw):
    """A random service-op script with nondecreasing op times."""
    n = draw(st.integers(min_value=4, max_value=14))
    ops, t, jid = [], 0.0, 0
    for _ in range(n):
        t += draw(st.floats(min_value=0.0, max_value=25.0))
        kind = draw(st.sampled_from(["submit", "submit", "submit", "cancel", "reconfigure", "tick"]))
        if kind == "submit":
            ops.append((
                "submit", t, jid,
                draw(st.floats(min_value=0.5, max_value=30.0)),
                draw(st.floats(min_value=5.0, max_value=120.0)),
                draw(st.sampled_from(["linear", "capped@2g", "capped@4g", "exp-0.60", "log-0.65"])),
                draw(st.sampled_from(["inference", "training"])),
            ))
            jid += 1
        elif kind == "cancel":
            ops.append(("cancel", t, draw(st.integers(min_value=0, max_value=max(jid, 1)))))
        elif kind == "reconfigure":
            ops.append(("reconfigure", t, draw(st.sampled_from([1, 2, 3, 6, 9]))))
        else:
            ops.append(("tick", t))
    return ops


def _run_script(side, scheduler, ops, perturb, seed=0):
    """Apply a script; when ``perturb``, interleave partial advances,
    snapshots and pickle round trips, none of which may change the outcome."""
    _, jm, simm, engine_cls, sched, _, _ = SIDES[side]
    rng = random.Random(seed)
    eng = engine_cls(simm.MIGSimulator(sched(scheduler)), policy=simm.DayNightPolicy(), stream_open=True)
    outcomes = []
    for idx, op in enumerate(ops):
        t = op[1]
        if perturb:
            if rng.random() < 0.5:
                eng.run_until(t * rng.random(), inclusive=False)
                eng.snapshot()
            if rng.random() < 0.25:
                eng = engine_cls.from_snapshot_bytes(eng.to_snapshot_bytes())
        eng.run_until(t, inclusive=False)
        try:
            if op[0] == "submit":
                _, t, jid, work, slack, elast, jk = op
                eng.inject(jm.Job(job_id=jid, kind=jm.JobKind(jk), arrival=t, work=work,
                                  deadline=t + slack, elasticity=jm.elasticity_from_label(elast)))
                outcomes.append((idx, "ok"))
            elif op[0] == "cancel":
                outcomes.append((idx, eng.cancel(op[2])))
            elif op[0] == "reconfigure":
                outcomes.append((idx, eng.reconfigure(op[2])))
            else:
                if perturb:
                    eng.run_until(t, inclusive=False)
                outcomes.append((idx, "tick"))
        except (ValueError, KeyError, RuntimeError) as e:
            outcomes.append((idx, type(e).__name__))
    eng.close_stream()
    eng.drain()
    return _res(eng.result()), list(eng.sim.config_trace), outcomes


# derandomized with no deadline: the same six scripts on every run, none
# failed for taking longer than hypothesis's 200 ms default on a loaded worker
@settings(max_examples=6, deadline=None, derandomize=True)
@given(op_scripts())
def test_interleaving_property_bit_identity_against_reference(ops):
    """Perturbed runs of the port (partial advances, snapshots, pickle round
    trips) agree with the reference's unperturbed run of the same ops:
    results, config traces and per-op outcomes, error types included, for
    each scheduler family."""
    for scheduler in SCHEDULERS:
        base = _run_script("ref", scheduler, ops, perturb=False)
        assert _run_script("port", scheduler, ops, perturb=False) == base
        for seed in (1, 2):
            got = _run_script("port", scheduler, ops, perturb=True, seed=seed)
            assert got == base, (scheduler, seed, ops)


# ---------------------------------------------------------------------------
# the golden file of chip_smoke.py's service and cluster_day phases


@pytest.fixture(scope="module")
def golden():
    return json.loads(G.GOLDEN.read_text())


@pytest.mark.parametrize("section", ["service", "cluster"])
@pytest.mark.parametrize("side", ["ref", "port"])
def test_golden_file_equals_a_fresh_run(golden, section, side, tmp_path):
    """The checked-in file is the reference's current output, and the port
    reproduces it (rtol 1e-9, integers exact; 0 difference expected)."""
    pkg = REF if side == "ref" else PORT
    got = G.service_golden(pkg, tmp_path) if section == "service" else G.cluster_golden(pkg)
    want = golden[section]
    assert G.off(got, want) == []
    assert G.max_rel(got, want) == 0.0


def _write_golden() -> None:
    with tempfile.TemporaryDirectory() as d:
        out = {"inputs": {"crash_checkpoint_min": G.CRASH_CHECKPOINT_MIN, "fleet": list(G.FLEET_PROFILES),
                          "replay_jobs": G.REPLAY_JOBS, "load_jobs": G.LOAD_JOBS,
                          "cluster_days": G.CLUSTER_DAYS, "cluster_seed": G.CLUSTER_SEED,
                          "failures": G.FAILURES, "params": "benchmarks/baselines/rl_dqn_params.npz"},
               **G.golden(REF, Path(d))}
    G.GOLDEN.write_text(json.dumps(out, indent=1, sort_keys=False) + "\n")
    print(f"wrote {G.GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_service.py --write-golden")
    _write_golden()
