"""Cluster workload: diurnal arrivals of (arch x shape) jobs on the pod.

Same §V-A arrival process as the paper layer, but per-job attributes come
from the real substrate: the job's elasticity is the roofline-derived curve
of its (arch, shape) and its work is the service time of its quantum count
on a 1-slot sub-mesh.

The port's own copy of ``repro.cluster.workload``: the same seeded numpy
draws in the same order, so a seed gives the same jobs in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.elasticity import arch_elasticity, service_minutes
from repro_torch.core.jobs import Job, JobKind
from repro_torch.core.workload import WorkloadSpec, _sample_arrivals

__all__ = ["ClusterWorkloadSpec", "generate_cluster_jobs", "DEFAULT_MIX"]

# (arch, shape, weight, kind): a serving-heavy mix with fine-tuning bursts —
# mirrors the paper's 80/20 inference/training split.
DEFAULT_MIX: Sequence[Tuple[str, str, float, JobKind]] = (
    ("gemma3-1b", "decode_32k", 0.22, JobKind.INFERENCE),
    ("gemma3-12b", "decode_32k", 0.12, JobKind.INFERENCE),
    ("mixtral-8x7b", "decode_32k", 0.12, JobKind.INFERENCE),
    ("xlstm-350m", "decode_32k", 0.10, JobKind.INFERENCE),
    ("whisper-base", "decode_32k", 0.08, JobKind.INFERENCE),
    ("phi-3-vision-4.2b", "prefill_32k", 0.08, JobKind.INFERENCE),
    ("jamba-v0.1-52b", "long_500k", 0.08, JobKind.INFERENCE),
    ("gemma3-1b", "train_4k", 0.07, JobKind.TRAINING),
    ("stablelm-3b", "train_4k", 0.06, JobKind.TRAINING),
    ("granite-moe-3b-a800m", "train_4k", 0.05, JobKind.TRAINING),
    ("mixtral-8x7b", "train_4k", 0.02, JobKind.TRAINING),
)


@dataclasses.dataclass(frozen=True)
class ClusterWorkloadSpec:
    horizon_min: float = 24 * 60.0
    constant_rate: Optional[float] = None
    mix: Sequence[Tuple[str, str, float, JobKind]] = DEFAULT_MIX
    slack_lo: float = 1.2
    slack_hi: float = 4.0
    work_scale: float = 1.0  # scales job quanta (load knob)

    def as_core_spec(self) -> WorkloadSpec:
        return WorkloadSpec(
            horizon_min=self.horizon_min, constant_rate=self.constant_rate
        )


def generate_cluster_jobs(
    spec: ClusterWorkloadSpec, seed: int
) -> List[Job]:
    rng = np.random.default_rng(seed)
    arrivals = _sample_arrivals(spec.as_core_spec(), rng)
    weights = np.asarray([m[2] for m in spec.mix], np.float64)
    weights = weights / weights.sum()
    jobs: List[Job] = []
    for i, t in enumerate(arrivals):
        arch, shape, _, kind = spec.mix[int(rng.choice(len(spec.mix), p=weights))]
        elast = arch_elasticity(arch, shape)
        # work = 1-slot service time of the job quantum, jittered 0.5-1.5x
        work = service_minutes(arch, shape, 1) * spec.work_scale
        work *= rng.uniform(0.5, 1.5)
        work = float(np.clip(work, 1.0 / 60.0, 240.0))
        slack = rng.uniform(spec.slack_lo, spec.slack_hi)
        deadline = t + slack * elast.duration(work, 7)
        jobs.append(
            Job(
                job_id=i,
                kind=kind,
                arrival=t,
                work=work,
                deadline=deadline,
                elasticity=elast,
            )
        )
    return jobs
