"""TPU-cluster adaptation of the paper (DESIGN.md §2).

The pod (16x16 = 256 chips) is partitioned into the paper's 12 slice
profiles ("slots" of 36 chips; a 7g slice = the full pod's compute pool).
Jobs are train/prefill/decode invocations of the 10 assigned architectures;
their throughput elasticity across slice sizes is *derived from the dry-run
roofline terms* instead of drawn from synthetic distributions — reproducing
the paper's key premise (mixed linear/capped/sublinear workloads) from first
principles.

The port's own copy of ``repro.cluster``: host code over the simulated pod's
modelled inputs (:mod:`repro_torch.cluster.pod`); nothing here runs on the
card.
"""

from repro_torch.cluster.elasticity import (
    arch_elasticity,
    classify_elasticity,
    service_minutes,
)
from repro_torch.cluster.workload import ClusterWorkloadSpec, generate_cluster_jobs

__all__ = [
    "arch_elasticity",
    "classify_elasticity",
    "service_minutes",
    "ClusterWorkloadSpec",
    "generate_cluster_jobs",
]
