"""The ET multi-objective metric (paper §IV-A).

For ``n`` simulations with energy ``x_i`` (Wh here; any consistent unit) and
average tardiness ``y_i`` (minutes):

    ET = (1/n) * sum_i (a*x_i + y_i) / (a + 1)

The scaling factor ``a`` is fixed *across an experiment*: with ``s`` the
global mean energy and ``t`` the global mean average-tardiness over the
simulations of all algorithms in the experiment, ``a = t / (2 s)`` — i.e.
after normalization tardiness is penalized 2x relative to energy.
Lower ET is better.

The port's own copy of ``repro.core.metrics`` (every name), plus
:func:`summarize_results`, the per-model means of Tables II/III, copied from
``repro.sweep.grids``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

__all__ = [
    "SimResult",
    "TenantSLOStats",
    "merge_tenant_stats",
    "slo_attainment",
    "et_scale_factor",
    "et_metric",
    "et_table",
    "summarize_results",
]


@dataclasses.dataclass(frozen=True)
class TenantSLOStats:
    """Per-tenant serving outcome: request count, SLO hits, latency mass.

    ``latency_sum_min`` is the sum of arrival-to-completion latencies so
    stats from different devices merge exactly (means do not).
    """

    jobs: int
    attained: int
    latency_sum_min: float

    @property
    def attainment(self) -> float:
        """Fraction of requests that met their SLO (1.0 for zero requests)."""
        if self.jobs == 0:
            return 1.0
        return self.attained / self.jobs

    @property
    def mean_latency_min(self) -> float:
        if self.jobs == 0:
            return 0.0
        return self.latency_sum_min / self.jobs


def merge_tenant_stats(
    parts: Iterable[Mapping[str, TenantSLOStats]],
) -> Dict[str, TenantSLOStats]:
    """Merge per-device tenant stats into fleet totals (exact, order-free)."""
    out: Dict[str, TenantSLOStats] = {}
    for part in parts:
        for tenant, st in part.items():
            prev = out.get(tenant)
            if prev is None:
                out[tenant] = st
            else:
                out[tenant] = TenantSLOStats(
                    jobs=prev.jobs + st.jobs,
                    attained=prev.attained + st.attained,
                    latency_sum_min=prev.latency_sum_min + st.latency_sum_min,
                )
    return out


def slo_attainment(tenants: Mapping[str, TenantSLOStats]) -> float:
    """Request-weighted SLO attainment across tenants (1.0 when empty)."""
    jobs = sum(st.jobs for st in tenants.values())
    if jobs == 0:
        return 1.0
    return sum(st.attained for st in tenants.values()) / jobs


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Outcome of one simulation run.

    ``tenants`` is populated only by serving workloads whose jobs carry a
    tenant id (DESIGN.md §9); batch simulations leave it empty, keeping
    their serialized result dicts byte-identical to pre-serving baselines.
    """

    energy_wh: float
    avg_tardiness: float
    num_jobs: int = 0
    total_tardiness: float = 0.0
    preemptions: int = 0
    repartitions: int = 0
    max_tardiness: float = 0.0
    deadline_misses: int = 0
    busy_slot_minutes: float = 0.0  # integral of busy slots over time
    extra: Mapping[str, float] = dataclasses.field(default_factory=dict)
    tenants: Mapping[str, TenantSLOStats] = dataclasses.field(default_factory=dict)

    @property
    def slo_attainment(self) -> float:
        """Request-weighted SLO attainment over all tenants (1.0 if none)."""
        return slo_attainment(self.tenants)


def et_scale_factor(results: Iterable[SimResult]) -> float:
    """``a = t / (2 s)`` over ALL provided simulations (all algorithms)."""
    results = list(results)
    if not results:
        raise ValueError("no results")
    s = sum(r.energy_wh for r in results) / len(results)
    t = sum(r.avg_tardiness for r in results) / len(results)
    if s <= 0.0:
        return 1.0
    return t / (2.0 * s)


def et_metric(results: Sequence[SimResult], a: float) -> float:
    """ET for one algorithm's simulations given the experiment-wide ``a``."""
    if not results:
        raise ValueError("no results")
    return sum((a * r.energy_wh + r.avg_tardiness) / (a + 1.0) for r in results) / len(
        results
    )


def et_table(
    per_algo_results: Mapping[str, Sequence[SimResult]],
) -> Tuple[Dict[str, float], float]:
    """ET per algorithm with a shared ``a`` (as in Tables II/III).

    Returns (``{algo: ET}``, ``a``).
    """
    all_results: List[SimResult] = []
    for rs in per_algo_results.values():
        all_results.extend(rs)
    a = et_scale_factor(all_results)
    table = {name: et_metric(rs, a) for name, rs in per_algo_results.items()}
    return table, a


def summarize_results(results: Sequence[SimResult]) -> Dict[str, float]:
    """Mean of the headline per-run metrics (matches Tables II/III columns)."""
    n = max(len(results), 1)
    return {
        "energy_wh": sum(r.energy_wh for r in results) / n,
        "avg_tardiness": sum(r.avg_tardiness for r in results) / n,
        "preemptions": sum(r.preemptions for r in results) / n,
        "repartitions": sum(r.repartitions for r in results) / n,
        "deadline_misses": sum(r.deadline_misses for r in results) / n,
    }
