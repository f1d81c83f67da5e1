"""Cluster-day simulation: the paper's scheduler in charge of a TPU pod.

``python -m repro_torch.launch.cluster_sim --policy dynamic --iterations 20``

Runs simulated days where diurnal (arch x shape) jobs from the assigned
architectures hit one simulated 256-chip TPU v5e pod that EDF-SS schedules
across the 12 partition profiles, with the repartitioning policy of your
choice; energy uses the simulated pod's power curve.  ``--failures`` injects
Poisson slice failures (jobs requeue with checkpoint-gap work loss; the
policy degrades to a holed configuration until repair), the paper's
mechanism doubling as the recovery path.

The port's own copy of ``repro.launch.cluster_sim``.  The pod, its jobs and
the schedulers are float64 host code with the reference's order of
operations, so a day gives the same :class:`SimResult` in both packages.
``--policy dynamic`` runs the greedy DQN (``--dqn-params``), whose Q network
runs on the card unless ``--device cpu``.  :class:`QueueHeuristicPolicy` is
also the policy registry's ``"heuristic"`` and the host trainer's guide
(``train_rl --backend host``).
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

from repro_torch.cluster.workload import ClusterWorkloadSpec, generate_cluster_jobs
from repro_torch.core.metrics import SimResult
from repro_torch.core.power import TPU_V5E_POD
from repro_torch.core.schedulers import make_scheduler
from repro_torch.core.simulator import (
    DayNightPolicy,
    MIGSimulator,
    RepartitionPolicy,
    StaticPolicy,
)
from repro_torch.distributed.fault_tolerance import FailureModel

__all__ = [
    "POD_REPARTITION_MIN",
    "QueueHeuristicPolicy",
    "FailureAwarePolicy",
    "queue_heuristic_policy",
    "day_policy_factory",
    "run_days",
    "main",
]

# pod repartition penalty: rebuild meshes + restore job state from ckpt (min)
POD_REPARTITION_MIN = 0.5

DQN_PARAMS = "artifacts/dqn_params.npz"


class QueueHeuristicPolicy:
    """Queue-pressure heuristic (the paper's Fig. 11 intuition distilled)."""

    initial_config = 2

    def decide(self, t, sim):
        snap = sim.snapshot()  # observable state only (engine snapshot API)
        q = snap.jobs_in_system
        tgt = 1 if q <= 1 else 2 if q <= 2 else 3 if q <= 3 else 6 if q <= 5 else 9 if q <= 7 else 12
        return tgt if tgt != snap.config_id else None

    def next_timer(self, t):
        return None


def queue_heuristic_policy() -> QueueHeuristicPolicy:
    return QueueHeuristicPolicy()


class FailureAwarePolicy:
    """Wraps a policy with slice-failure handling.

    On failure: running jobs are requeued by the forced repartition, each
    charged the checkpoint-gap work loss; the pod runs a holed configuration
    (config 5: 6/7 slots) until repair.
    """

    DEGRADED_CONFIG = 5

    def __init__(self, inner: RepartitionPolicy, failures, model: FailureModel):
        self.inner = inner
        self.initial_config = inner.initial_config
        self.events = list(failures)  # [(t_fail, slice_idx, t_repair)]
        self.outages: List = []
        self.recoveries = 0
        self.lost_work_min = 0.0

    def _outage_at(self, t: float) -> bool:
        return any(f <= t < r for f, _, r in self.events)

    def decide(self, t, sim):
        if self._outage_at(t):
            if sim.partition.config_id != self.DEGRADED_CONFIG:
                # charge checkpoint-gap loss to every running job
                for jid in list(sim.assignment):
                    job = sim.active[jid]
                    lost = min(10.0, job.work - job.remaining)
                    lost = max(lost, 0.0) * 0.5  # expected gap/2
                    job.remaining = min(job.remaining + lost, job.work)
                    self.lost_work_min += lost
                self.recoveries += 1
                return self.DEGRADED_CONFIG
            return None
        return self.inner.decide(t, sim)

    def next_timer(self, t):
        bounds = [x for f, _, r in self.events for x in (f, r) if x > t + 1e-9]
        inner = self.inner.next_timer(t)
        if inner is not None:
            bounds.append(inner)
        return min(bounds) if bounds else None


def day_policy_factory(
    policy: str, dqn_params: str = DQN_PARAMS, device=None
) -> Callable[[], RepartitionPolicy]:
    """``main``'s per-day policy factory for ``--policy``.

    ``"dynamic"`` builds, for each day, a learner with ``dqn_params`` loaded
    on ``device`` (the card unless ``"cpu"``) and its greedy policy, as the
    reference's ``main`` does.
    """
    if policy == "static":
        return lambda: StaticPolicy(3)
    if policy == "daynight":
        return DayNightPolicy
    if policy == "heuristic":
        return queue_heuristic_policy
    if policy != "dynamic":
        raise ValueError(f"unknown policy {policy!r}; valid: static, daynight, heuristic, dynamic")
    from repro_torch.core.rl import DQNConfig, DQNLearner, greedy_policy
    from repro_torch.core.rl.env import FEATURE_DIM
    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def factory():
        learner = DQNLearner(DQNConfig(state_dim=FEATURE_DIM), device=dev)
        learner.load(dqn_params)
        return greedy_policy(learner)

    return factory


def run_days(
    policy_factory,
    iterations: int = 10,
    spec: Optional[ClusterWorkloadSpec] = None,
    scheduler: str = "EDF-SS",
    failures: Optional[FailureModel] = None,
    seed: int = 0,
) -> List[SimResult]:
    spec = spec or ClusterWorkloadSpec()
    sim = MIGSimulator(
        make_scheduler(scheduler),
        power_model=TPU_V5E_POD,
        repartition_penalty_min=POD_REPARTITION_MIN,
    )
    out: List[SimResult] = []
    for it in range(iterations):
        jobs = generate_cluster_jobs(spec, seed=seed + it)
        policy = policy_factory()
        if failures is not None:
            fl = failures.sample_failures(7, spec.horizon_min)
            policy = FailureAwarePolicy(policy, fl, failures)
        out.append(sim.run(jobs, policy=policy))
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--policy",
        default="heuristic",
        choices=["static", "daynight", "heuristic", "dynamic"],
    )
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--failures", action="store_true")
    ap.add_argument("--dqn-params", default=DQN_PARAMS)
    ap.add_argument("--device", default=None,
                    help="where --policy dynamic runs its Q network (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    factory = day_policy_factory(args.policy, args.dqn_params, args.device)
    fm = FailureModel(mtbf_minutes=2 * 24 * 60.0) if args.failures else None
    results = run_days(factory, iterations=args.iterations, failures=fm, seed=args.seed)
    n = len(results)
    print(
        f"policy={args.policy} days={n} "
        f"energy={sum(r.energy_wh for r in results)/n/1000.0:.1f} kWh/day "
        f"avg_tardiness={sum(r.avg_tardiness for r in results)/n:.3f} min "
        f"repartitions={sum(r.repartitions for r in results)/n:.1f}/day "
        f"misses={sum(r.deadline_misses for r in results)/n:.1f}/day"
    )


if __name__ == "__main__":
    main()
