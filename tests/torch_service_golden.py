"""The inputs of ``tests/data/torch_service_golden.json`` and the comparisons it is read with.

The golden file holds what the JAX package's scheduler service and TPU-pod
cluster day give on the CPU (written by ``tests/test_torch_service.py
--write-golden``):

* ``service`` — the uninterrupted result of each cell of the crash matrix
  (``daynight`` and ``heuristic`` x ``partial`` and ``drain``, the op
  scripts of tests/test_service_recovery.py), of fleet mode
  (2 devices, trace-scaled seed 9, 4 hours), of the replay feed that a
  SIGKILL interrupts (trace-scaled seed 3, 200 jobs), of the soak's full
  trace-scaled day, of the socket round trip's script and of the socket
  load's feed (``scripts/bench_service.py``'s grid of arrivals);
* ``cluster`` — ``run_days`` on the simulated pod: static config 3,
  daynight and the queue heuristic for ``CLUSTER_DAYS`` days each, the
  heuristic under ``FailureModel(mtbf_minutes=8*60, seed=3)``, and the
  greedy DQN with the checked-in ``benchmarks/baselines/rl_dqn_params.npz``
  with and without those failures.

Either package's classes go in through a :class:`Package`; this module
imports nothing of JAX or of either package, so the CPU tests and
``chip_smoke.py`` (on a machine without JAX) share one copy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_service_golden.json"
RL_PARAMS = ROOT / "benchmarks" / "baselines" / "rl_dqn_params.npz"
RTOL = 1e-9  # floats; integers, strings and keys exactly

# the crash matrix of tests/test_service_recovery.py
POLICIES = ("daynight", "heuristic")
MODES = ("partial", "drain")
CRASH_CHECKPOINT_MIN = 90.0
CRASH_CUTS = 3
# fleet mode (tests/test_service.py::test_service_fleet_mode_checkpoint_recovery)
FLEET_PROFILES = ("a100-250w", "a30-165w")
FLEET_SCENARIO = dict(name="trace-scaled", seed=9, horizon_min=240.0)
FLEET_CHECKPOINT_MIN = 100.0
# the replay a SIGKILL interrupts (test_sigkill_mid_replay_recovers_bit_identical)
REPLAY_JOBS = 200
REPLAY_SEED = 3
REPLAY_CHECKPOINT_MIN = 60.0
REPLAY_PACE_MS = 4.0
REPLAY_KILL_AFTER = 25  # WAL lines before the kill
# the soak: a full trace-scaled day, with its bounds
SOAK_SEED = 0
SOAK_CHECKPOINT_MIN = 120.0
SOAK_WAL_MAX_BYTES = 1_000_000
SOAK_MAX_CHECKPOINTS = 2
SOAK_RSS_GROWTH_KB = 200_000
SOAK_P99_S = 0.05
# the socket load (scripts/bench_service.py's feed and floors)
LOAD_JOBS = 6000
LOAD_ARRIVAL_DT_MIN = 0.01
LOAD_WORK = 0.05
LOAD_CHECKPOINT_MIN = 30.0
LOAD_POLICY = "static:7"
LOAD_WARMUP = 50
LOAD_MIN_JOBS_PER_MIN = 5000.0
LOAD_MAX_P99_MS = 50.0
# the pod's days
CLUSTER_DAYS = 2
CLUSTER_SEED = 5
FAILURES = dict(mtbf_minutes=8 * 60.0, seed=3)


@dataclasses.dataclass(frozen=True)
class Package:
    """One package's classes and functions that the golden runs use."""

    SchedulerService: Any
    ServiceConfig: Any
    ServiceServer: Any
    ServiceClient: Any
    wait_for_socket: Callable
    read_wal: Callable
    sim_result_to_dict: Callable
    generate_scenario: Callable
    run_days: Callable
    queue_heuristic_policy: Callable
    StaticPolicy: Any
    DayNightPolicy: Any
    FailureModel: Any
    # params path -> a per-day greedy-DQN policy factory
    dqn_factory: Callable[[str], Callable]


def package_from(service: Any, scenarios: Any, cluster_sim: Any, simulator: Any,
                 fault_tolerance: Any, dqn_factory: Callable[[str], Callable]) -> Package:
    """A :class:`Package` from one package's modules: ``service``,
    ``core.scenarios``, ``launch.cluster_sim``, ``core.simulator`` and
    ``distributed.fault_tolerance``."""
    return Package(
        SchedulerService=service.SchedulerService, ServiceConfig=service.ServiceConfig,
        ServiceServer=service.ServiceServer, ServiceClient=service.ServiceClient,
        wait_for_socket=service.wait_for_socket, read_wal=service.read_wal,
        sim_result_to_dict=service.sim_result_to_dict, generate_scenario=scenarios.generate_scenario,
        run_days=cluster_sim.run_days, queue_heuristic_policy=cluster_sim.queue_heuristic_policy,
        StaticPolicy=simulator.StaticPolicy, DayNightPolicy=simulator.DayNightPolicy,
        FailureModel=fault_tolerance.FailureModel, dqn_factory=dqn_factory,
    )


# ------------------------------ comparisons ----------------------------------


def as_dict(res: Any) -> Dict[str, Any]:
    """A SimResult (or FleetResult) as the JSON the golden file stores."""
    return json.loads(json.dumps(dataclasses.asdict(res)))


def fleet_dict(fr: Any) -> Dict[str, Any]:
    return {"aggregate": as_dict(fr.aggregate), "per_device": [as_dict(r) for r in fr.per_device],
            "dispatch_counts": list(fr.dispatch_counts)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-300) if a != b else 0.0


def off(got: Any, want: Any, rtol: float = RTOL, path: str = "") -> List[str]:
    """Where ``got`` differs from ``want``: floats beyond ``rtol`` relative,
    anything else (integers, strings, keys, lengths) not equal."""
    if isinstance(want, dict) and isinstance(got, dict):
        if set(got) != set(want):
            return [f"{path}: keys {sorted(got)} != {sorted(want)}"]
        return [p for k in want for p in off(got[k], want[k], rtol, f"{path}/{k}")]
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return [f"{path}: length {len(got)} != {len(want)}"]
        return [p for i, (g, w) in enumerate(zip(got, want)) for p in off(g, w, rtol, f"{path}[{i}]")]
    if isinstance(want, float) and isinstance(got, float):
        return [] if _rel(got, want) <= rtol else [f"{path}: {got!r} != {want!r}"]
    if type(got) is not type(want) or got != want:
        return [f"{path}: {got!r} != {want!r}"]
    return []


def max_rel(got: Any, want: Any) -> float:
    """The largest relative difference over the floats of two equal-shaped trees."""
    if isinstance(want, dict) and isinstance(got, dict):
        return max((max_rel(got[k], want[k]) for k in want if k in got), default=0.0)
    if isinstance(want, list) and isinstance(got, list):
        return max((max_rel(g, w) for g, w in zip(got, want)), default=0.0)
    if isinstance(want, float) and isinstance(got, float):
        return _rel(got, want)
    return 0.0


# ------------------------------ the service ----------------------------------


def script(pkg: Package, seed: int, n: int = 110, horizon_min: float = 420.0) -> List[Tuple]:
    """An op script: submissions with interleaved cancels and reconfigures."""
    jobs = pkg.generate_scenario("trace-scaled", seed=seed, horizon_min=horizon_min)[:n]
    ops: List[Tuple] = []
    for k, job in enumerate(jobs):
        ops.append(("submit", job))
        if k % 17 == 11:
            ops.append(("cancel", jobs[k - 3].job_id))
        if k % 29 == 23:
            ops.append(("reconfigure", 6 if (k // 29) % 2 == 0 else 2))
    return ops


def drive(svc: Any, ops: Sequence[Tuple]) -> List[str]:
    """Apply ops; an invalid one is rejected before it is logged, and its
    error type is its outcome."""
    outcomes = []
    for op in ops:
        try:
            if op[0] == "submit":
                svc.submit(op[1])
            elif op[0] == "cancel":
                svc.cancel(op[1])
            else:
                svc.reconfigure(op[1])
            outcomes.append("ok")
        except (ValueError, RuntimeError, KeyError) as e:
            outcomes.append(type(e).__name__)
    return outcomes


def resume_ops(svc: Any, ops: Sequence[Tuple]) -> List[Tuple]:
    """The ops a client re-sends after recovery: submissions the service
    already knows are skipped."""
    return [op for op in ops if not (op[0] == "submit" and op[1].job_id in svc.known_jobs)]


def crash_config(pkg: Package, policy: str, mode: str) -> Any:
    return pkg.ServiceConfig(policy=policy, repartition_mode=mode,
                             checkpoint_every_min=CRASH_CHECKPOINT_MIN)


def crash_seed(policy: str, mode: str) -> int:
    return zlib.crc32(f"{policy}/{mode}".encode())


def crash_cuts(policy: str, mode: str, n_ops: int) -> List[int]:
    return sorted(random.Random(crash_seed(policy, mode)).sample(range(1, n_ops), CRASH_CUTS))


def crash_oracle(pkg: Package, workdir: Path, policy: str, mode: str) -> Dict[str, Any]:
    """A cell's uninterrupted run: its result and every op's outcome."""
    ops = script(pkg, crash_seed(policy, mode) % 16)
    svc = pkg.SchedulerService(workdir, crash_config(pkg, policy, mode))
    outcomes = drive(svc, ops)
    svc.close()
    res = as_dict(svc.result())
    svc.shutdown()
    return {"result": res, "outcomes": outcomes}


def crash_recovered(pkg: Package, workdir: Path, policy: str, mode: str) -> List[Dict[str, Any]]:
    """The cell killed (abandoned, no shutdown) at each seeded cut, recovered
    from header, checkpoint and WAL tail, resumed and closed."""
    ops = script(pkg, crash_seed(policy, mode) % 16)
    out = []
    for ci, cut in enumerate(crash_cuts(policy, mode, len(ops))):
        d = workdir / f"crash{ci}"
        victim = pkg.SchedulerService(d, crash_config(pkg, policy, mode))
        drive(victim, ops[:cut])
        victim.wal.close()
        del victim
        svc = pkg.SchedulerService(d)
        recovered = svc.recovered_ops
        drive(svc, resume_ops(svc, ops[cut:]))
        svc.close()
        out.append({"cut": cut, "recovered_ops": recovered, "result": as_dict(svc.result())})
        svc.shutdown()
    return out


def fleet_config(pkg: Package) -> Any:
    return pkg.ServiceConfig(policy="daynight", fleet_profiles=FLEET_PROFILES,
                             checkpoint_every_min=FLEET_CHECKPOINT_MIN)


def _fleet_jobs(pkg: Package) -> List:
    sc = FLEET_SCENARIO
    return pkg.generate_scenario(sc["name"], seed=sc["seed"], horizon_min=sc["horizon_min"])


def fleet_oracle(pkg: Package, workdir: Path) -> Dict[str, Any]:
    svc = pkg.SchedulerService(workdir, fleet_config(pkg))
    for job in _fleet_jobs(pkg):
        svc.submit(job)
    svc.close()
    got = fleet_dict(svc.fleet_result())
    svc.shutdown()
    return got


def fleet_recovered(pkg: Package, workdir: Path) -> Dict[str, Any]:
    """Half the feed, a checkpoint (the whole FleetStream pickled), a crash,
    recovery and the rest of the feed."""
    jobs = _fleet_jobs(pkg)
    svc = pkg.SchedulerService(workdir, fleet_config(pkg))
    for job in jobs[: len(jobs) // 2]:
        svc.submit(job)
    svc.checkpoint()
    svc.wal.close()
    del svc
    svc = pkg.SchedulerService(workdir)
    for job in jobs:
        if job.job_id not in svc.known_jobs:
            svc.submit(job)
    svc.close()
    got = fleet_dict(svc.fleet_result())
    svc.shutdown()
    return got


def replay_config(pkg: Package) -> Any:
    return pkg.ServiceConfig(policy="daynight", checkpoint_every_min=REPLAY_CHECKPOINT_MIN)


def replay_argv(package: str, workdir: Path) -> List[str]:
    """``python -m <package>.service replay``'s arguments for the feed."""
    return ["-m", f"{package}.service", "replay", "--dir", str(workdir), "--scenario", "trace-scaled",
            "--seed", str(REPLAY_SEED), "--max-jobs", str(REPLAY_JOBS), "--pace-ms", str(REPLAY_PACE_MS),
            "--policy", "daynight", "--checkpoint-every-min", str(REPLAY_CHECKPOINT_MIN)]


def _replay_jobs(pkg: Package) -> List:
    return pkg.generate_scenario("trace-scaled", seed=REPLAY_SEED)[:REPLAY_JOBS]


def replay_oracle(pkg: Package, workdir: Path) -> Dict[str, Any]:
    svc = pkg.SchedulerService(workdir, replay_config(pkg))
    for job in _replay_jobs(pkg):
        svc.submit(job)
    svc.close()
    res = as_dict(svc.result())
    svc.shutdown()
    return res


def wal_lines(path: Path) -> int:
    if not path.exists():
        return 0
    with open(path) as fh:
        return sum(1 for _ in fh)


def replay_resume(pkg: Package, workdir: Path) -> Dict[str, Any]:
    """Recover a killed replay's workdir and feed it the rest of the jobs."""
    svc = pkg.SchedulerService.recover(workdir)
    known = len(svc.known_jobs)
    for job in _replay_jobs(pkg):
        if job.job_id not in svc.known_jobs:
            svc.submit(job)
    svc.close()
    res = as_dict(svc.result())
    svc.shutdown()
    return {"known_at_recovery": known, "recovered_ops": svc.recovered_ops, "result": res}


def _rss_kb() -> int:
    """This process's resident set now, in KB (Linux)."""
    with open("/proc/self/statm") as fh:
        pages = int(fh.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") // 1024


def soak(pkg: Package, workdir: Path) -> Dict[str, Any]:
    """A full trace-scaled day through the service: the result and the
    soak's measures (largest WAL, checkpoints kept, resident-set growth over
    the second half, submit latency percentiles)."""
    jobs = pkg.generate_scenario("trace-scaled", seed=SOAK_SEED)
    svc = pkg.SchedulerService(workdir, pkg.ServiceConfig(policy="daynight",
                                                          checkpoint_every_min=SOAK_CHECKPOINT_MIN))
    latencies, max_wal, rss_mid = [], 0, None
    t_start = time.perf_counter()
    for i, job in enumerate(jobs):
        t0 = time.perf_counter()
        svc.submit(job)
        latencies.append(time.perf_counter() - t0)
        max_wal = max(max_wal, svc.wal.size_bytes())
        if i == len(jobs) // 2:
            rss_mid = _rss_kb()
    wall_s = time.perf_counter() - t_start
    rss_growth = _rss_kb() - rss_mid
    svc.checkpoint()
    wal_after = svc.wal.size_bytes()
    ckpts = len(list(workdir.glob("ckpt-*.pkl")))
    in_engine = len(svc.backend.sim.completed)
    svc.close()
    res = svc.result()
    svc.shutdown()
    lat = sorted(latencies)
    return {
        "result": as_dict(res), "jobs": len(jobs), "wall_s": wall_s, "max_wal_bytes": max_wal,
        "wal_after_checkpoint": wal_after, "checkpoints": ckpts, "completed_in_engine": in_engine,
        "rss_growth_kb": rss_growth, "p50_ms": lat[len(lat) // 2] * 1e3,
        "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3,
        "all_accounted": res.num_jobs + int(res.extra.get("cancelled_jobs", 0)) == len(jobs),
    }


def soak_ok(m: Dict[str, Any]) -> bool:
    return (m["max_wal_bytes"] < SOAK_WAL_MAX_BYTES and m["wal_after_checkpoint"] == 0
            and m["checkpoints"] <= SOAK_MAX_CHECKPOINTS and m["completed_in_engine"] == 0
            and m["rss_growth_kb"] < SOAK_RSS_GROWTH_KB and m["p99_ms"] < SOAK_P99_S * 1e3
            and m["all_accounted"])


def socket_script(client: Any) -> Dict[str, Any]:
    """tests/test_service.py's round trip through a client: every response
    that must hold, and the final result."""
    checks = {}
    checks["ping"] = client.ping()["pong"] is True
    out = client.submit(job_id=0, arrival=0.0, work=1.0, deadline_slack_min=30.0, elasticity="linear")
    checks["submitted"] = out["state"] == "submitted"
    checks["auto_id"] = client.submit(arrival=1.0, work=200.0)["job_id"] == 1
    checks["status"] = client.status()["submitted"] == 2
    checks["job_status"] = client.status(job_id=1)["state"] in ("pending", "queued", "running")
    checks["reconfigure"] = client.reconfigure(6)["changed"] in (True, False)
    checks["cancel"] = client.cancel(1)["disposition"] in ("unarrived", "dequeued", "preempted")
    for name, req, msg in (("cancel_again", {"cmd": "cancel", "job_id": 1}, "terminal state"),
                           ("unknown_cmd", {"cmd": "warp"}, "unknown command")):
        try:
            client.request(req)
            checks[name] = False
        except RuntimeError as e:
            checks[name] = msg in str(e)
    checks["checkpoint"] = bool(client.checkpoint())
    res = client.close_stream()
    checks["result_again"] = client.result() == res
    return {"checks": checks, "result": res}


def socket_oracle(pkg: Package, workdir: Path) -> Dict[str, Any]:
    """The round trip's ops on an in-process service (what the server
    applies for each request)."""
    svc = pkg.SchedulerService(workdir, socket_config(pkg))
    svc.submit_request({"job_id": 0, "arrival": 0.0, "work": 1.0, "deadline_slack_min": 30.0,
                        "elasticity": "linear"})
    svc.submit_request({"arrival": 1.0, "work": 200.0})
    svc.reconfigure(6)
    svc.cancel(1)
    svc.checkpoint()
    svc.close()
    res = pkg.sim_result_to_dict(svc.result())
    svc.shutdown()
    return res


def socket_config(pkg: Package) -> Any:
    return pkg.ServiceConfig(policy="daynight", checkpoint_every_min=0.0)


def load_fields(i: int) -> Dict[str, Any]:
    return {"job_id": i, "arrival": i * LOAD_ARRIVAL_DT_MIN, "work": LOAD_WORK,
            "deadline_slack_min": 60.0, "elasticity": "linear"}


def load_serve_args(workdir: Path, socket_path: Path) -> List[str]:
    """``serve``'s arguments after ``-m <package>.service`` for the load."""
    return ["serve", "--dir", str(workdir), "--socket", str(socket_path), "--speedup", "0",
            "--policy", LOAD_POLICY, "--scheduler", "EDF-SS",
            "--checkpoint-every-min", str(LOAD_CHECKPOINT_MIN)]


def load_feed(client: Any, jobs: int = LOAD_JOBS) -> Dict[str, Any]:
    """scripts/bench_service.py's feed through a client: throughput and
    latency percentiles (the first LOAD_WARMUP submissions excluded), the
    final result."""
    latencies = []
    t_start = time.perf_counter()
    for i in range(jobs):
        t0 = time.perf_counter()
        client.submit(**load_fields(i))
        latencies.append(time.perf_counter() - t0)
    elapsed = time.perf_counter() - t_start
    status = client.status()
    result = client.close_stream()
    lat = sorted(latencies[LOAD_WARMUP:] or latencies)

    def pct(q):
        return lat[min(int(q * (len(lat) - 1)), len(lat) - 1)] * 1e3

    return {"jobs": jobs, "wall_s": elapsed, "jobs_per_min": jobs / elapsed * 60.0,
            "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
            "sim_minutes": status["t"], "result": result}


def load_oracle(pkg: Package, workdir: Path, jobs: int = LOAD_JOBS) -> Dict[str, Any]:
    """The load's feed on an in-process service, as the server applies it."""
    svc = pkg.SchedulerService(workdir, pkg.ServiceConfig(
        policy=LOAD_POLICY, scheduler="EDF-SS", checkpoint_every_min=LOAD_CHECKPOINT_MIN))
    for i in range(jobs):
        svc.submit_request(load_fields(i))
    svc.close()
    res = pkg.sim_result_to_dict(svc.result())
    svc.shutdown()
    return res


def service_golden(pkg: Package, workdir: Path) -> Dict[str, Any]:
    """The ``service`` section: every uninterrupted run."""
    out: Dict[str, Any] = {"crash": {}}
    for policy in POLICIES:
        for mode in MODES:
            out["crash"][f"{policy}/{mode}"] = crash_oracle(pkg, workdir / f"crash-{policy}-{mode}",
                                                            policy, mode)
    out["fleet"] = fleet_oracle(pkg, workdir / "fleet")
    out["replay"] = replay_oracle(pkg, workdir / "replay")
    out["soak"] = soak(pkg, workdir / "soak")["result"]
    out["socket"] = socket_oracle(pkg, workdir / "socket")
    out["load"] = load_oracle(pkg, workdir / "load")
    return out


# ------------------------------ the pod's day --------------------------------


def cluster_runs(pkg: Package, dqn: bool = True) -> Dict[str, Callable[[], List]]:
    """Each golden pod run, as a thunk returning its days' SimResults."""
    fm = pkg.FailureModel(**FAILURES)
    runs: Dict[str, Callable[[], List]] = {
        "static": lambda: pkg.run_days(lambda: pkg.StaticPolicy(3), iterations=CLUSTER_DAYS,
                                       seed=CLUSTER_SEED),
        "daynight": lambda: pkg.run_days(pkg.DayNightPolicy, iterations=CLUSTER_DAYS, seed=CLUSTER_SEED),
        "heuristic": lambda: pkg.run_days(pkg.queue_heuristic_policy, iterations=CLUSTER_DAYS,
                                          seed=CLUSTER_SEED),
        "heuristic_failures": lambda: pkg.run_days(pkg.queue_heuristic_policy, iterations=CLUSTER_DAYS,
                                                   failures=fm, seed=CLUSTER_SEED),
    }
    if dqn:
        runs["dynamic"] = lambda: pkg.run_days(pkg.dqn_factory(str(RL_PARAMS)), iterations=CLUSTER_DAYS,
                                               seed=CLUSTER_SEED)
        runs["dynamic_failures"] = lambda: pkg.run_days(pkg.dqn_factory(str(RL_PARAMS)),
                                                        iterations=CLUSTER_DAYS, failures=fm,
                                                        seed=CLUSTER_SEED)
    return runs


def cluster_golden(pkg: Package) -> Dict[str, List[Dict[str, Any]]]:
    return {name: [as_dict(r) for r in run()] for name, run in cluster_runs(pkg).items()}


def golden(pkg: Package, workdir: Path) -> Dict[str, Any]:
    return {"service": service_golden(pkg, workdir), "cluster": cluster_golden(pkg)}
