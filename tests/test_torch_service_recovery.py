"""The port's crash recovery against the JAX package's uninterrupted runs, on the CPU.

Mirrors the reference's tests/test_service_recovery.py, each recovered run
held with ``==`` on :class:`SimResult` against the reference's run that
never crashed:

* the crash matrix: the port's service killed (abandoned without
  ``shutdown``) at seeded op indices, recovered from its header, newest
  checkpoint and WAL tail, resumed and closed, for ``daynight`` and
  ``heuristic`` x ``partial`` and ``drain``;
* recovery replays only the WAL tail; a torn last WAL line is dropped;
* a real SIGKILL of ``python -m repro_torch.service replay`` mid-feed;
* across packages: a workdir that one package wrote with
  ``checkpoint_every_min=0`` (header and WAL only) is recovered, resumed and
  closed by the other;
* the soak (``slow``, as in the reference): a full trace-scaled day with the
  WAL, the checkpoints, the resident set and the submit latency bounded.

The ops, cuts and bounds live in ``tests/torch_service_golden.py``, which
``chip_smoke.py``'s ``service`` phase shares.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_service_recovery.py``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import repro.core.scenarios as RSC
import repro.core.simulator as RSIM
import repro.distributed.fault_tolerance as RFT
import repro.launch.cluster_sim as RCS
import repro.service as RSV
import repro_torch.core.scenarios as PSC
import repro_torch.core.simulator as PSIM
import repro_torch.distributed.fault_tolerance as PFT
import repro_torch.launch.cluster_sim as PCS
import repro_torch.service as PSV

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_service_golden as G  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _no_dqn(params):
    raise AssertionError("the service runs no DQN")


REF = G.package_from(RSV, RSC, RCS, RSIM, RFT, _no_dqn)
PORT = G.package_from(PSV, PSC, PCS, PSIM, PFT, _no_dqn)
PACKAGES = {"ref": REF, "port": PORT}


@pytest.mark.parametrize("mode", G.MODES)
@pytest.mark.parametrize("policy", G.POLICIES)
def test_crash_recovery_bit_identical_to_reference(policy, mode, tmp_path):
    want = G.crash_oracle(REF, tmp_path / "ref", policy, mode)
    assert want["result"]["num_jobs"] > 50
    assert G.crash_oracle(PORT, tmp_path / "port", policy, mode) == want
    recovered = G.crash_recovered(PORT, tmp_path / "crash", policy, mode)
    assert len(recovered) == G.CRASH_CUTS
    for run in recovered:
        assert run["result"] == want["result"], (policy, mode, run["cut"])


def _tail_run(pkg, d, ops, k):
    cfg = pkg.ServiceConfig(policy="daynight", checkpoint_every_min=0.0)
    svc = pkg.SchedulerService(d, cfg)
    G.drive(svc, ops[:k])
    svc.checkpoint()
    assert pkg.read_wal(d / "wal.jsonl") == []  # rotated: every op snapshotted
    G.drive(svc, ops[k:])
    tail = len(pkg.read_wal(d / "wal.jsonl"))
    svc.wal.close()
    del svc
    svc2 = pkg.SchedulerService(d)
    recovered = svc2.recovered_ops
    svc2.close()
    res = G.as_dict(svc2.result())
    svc2.shutdown()
    return tail, recovered, res


def test_recovery_replays_only_the_wal_tail_as_reference(tmp_path):
    out = {}
    for side, pkg in PACKAGES.items():
        ops = G.script(pkg, 2, n=60)
        out[side] = _tail_run(pkg, tmp_path / side, ops, len(ops) // 2)
    tail, recovered, _ = out["port"]
    assert tail > 0 and recovered == tail
    assert out["port"] == out["ref"]


def _torn_run(pkg, d):
    cfg = pkg.ServiceConfig(policy="static", checkpoint_every_min=0.0)
    ops = G.script(pkg, 4, n=40)
    svc = pkg.SchedulerService(d / "svc", cfg)
    outcomes = G.drive(svc, ops)
    svc.wal.close()
    del svc
    wal_path = d / "svc" / "wal.jsonl"
    full = wal_path.read_bytes()
    wal_path.write_bytes(full[: len(full) - 17])  # tear the final record
    svc2 = pkg.SchedulerService(d / "svc")
    acked = len(pkg.read_wal(wal_path))
    recovered = svc2.recovered_ops
    svc2.close()
    # a run of just the acked prefix of the ops that committed agrees exactly
    committed = [op for op, o in zip(ops, outcomes) if o == "ok"]
    ref = pkg.SchedulerService(d / "prefix", cfg)
    G.drive(ref, committed[:acked])
    ref.close()
    out = (acked, recovered, G.as_dict(svc2.result()), G.as_dict(ref.result()))
    svc2.shutdown()
    ref.shutdown()
    return out


def test_recovery_tolerates_torn_wal_tail_as_reference(tmp_path):
    got = _torn_run(PORT, tmp_path / "port")
    assert got == _torn_run(REF, tmp_path / "ref")
    acked, recovered, res, prefix = got
    assert recovered == acked and res == prefix


@pytest.mark.parametrize("writer, reader", [("ref", "port"), ("port", "ref")])
def test_recovery_across_packages_from_header_and_wal(writer, reader, tmp_path):
    """A workdir written by one package with checkpoint_every_min=0 (its
    service.json and wal.jsonl, no pickle) recovers in the other to the
    reference's uninterrupted result."""
    policy, mode = "heuristic", "partial"
    want = G.crash_oracle(REF, tmp_path / "oracle", policy, mode)["result"]
    w, r = PACKAGES[writer], PACKAGES[reader]
    ops_w = G.script(w, G.crash_seed(policy, mode) % 16)
    cut = len(ops_w) * 2 // 3
    d = tmp_path / "svc"
    victim = w.SchedulerService(d, w.ServiceConfig(policy=policy, repartition_mode=mode,
                                                   checkpoint_every_min=0.0))
    G.drive(victim, ops_w[:cut])
    victim.wal.close()
    del victim
    assert sorted(p.name for p in d.iterdir()) == ["service.json", "wal.jsonl"]
    svc = r.SchedulerService(d)
    assert svc.recovered_ops > 0 and svc.config == r.ServiceConfig(
        policy=policy, repartition_mode=mode, checkpoint_every_min=0.0)
    ops_r = G.script(r, G.crash_seed(policy, mode) % 16)
    G.drive(svc, G.resume_ops(svc, ops_r[cut:]))
    svc.close()
    assert G.as_dict(svc.result()) == want
    svc.shutdown()


def _wait_for_wal_lines(path, n, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if G.wal_lines(path) >= n:
            return True
        time.sleep(0.02)
    return False


def test_sigkill_mid_replay_recovers_bit_identical_to_reference(tmp_path):
    """Kill ``python -m repro_torch.service replay`` with SIGKILL mid-feed;
    recovery in-process and the rest of the feed give the reference's
    uninterrupted result."""
    want = G.replay_oracle(REF, tmp_path / "ref")
    d = tmp_path / "victim"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    proc = subprocess.Popen([sys.executable, *G.replay_argv("repro_torch", d)], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        assert _wait_for_wal_lines(d / "wal.jsonl", G.REPLAY_KILL_AFTER), "service never started feeding"
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    got = G.replay_resume(PORT, d)
    assert 0 < got["known_at_recovery"] < G.REPLAY_JOBS  # genuinely mid-stream
    assert got["result"] == want


@pytest.mark.slow
def test_service_soak_full_day_bounded_and_equal_to_reference(tmp_path):
    """A full trace-scaled day: the WAL stays under 1 MB and is empty after a
    checkpoint, at most two checkpoints are kept, no completed job stays in
    the engine, the resident set grows less than 200 MB over the second
    half, p99 submit latency is under 50 ms, and the result is the
    reference's."""
    m = G.soak(PORT, tmp_path / "soak")
    assert G.soak_ok(m), m
    assert m["result"] == G.soak(REF, tmp_path / "ref")["result"]
