"""Multi-tenant SLO serving workloads: model configs mapped to MIG classes.

The port's own copy of ``repro.core.serving``. The paper's workload is
anonymous batch traffic; a serving fleet instead carries *tenants* — each a
deployed model with a request rate and a latency SLO.  This module joins the
repo's two halves: the architecture configs under
:mod:`repro_torch.configs` (gemma3, mixtral, whisper, …) and the MIG
slot-placement model of :mod:`repro_torch.core.slices`.

The mapping is memory-first, the way MIG serving deployments actually pick
instance types (MIG-Serving, arxiv 2109.11067): a model's weight footprint
``param_count × bytes_per_param × overhead`` must fit the slice's memory,
and the smallest of the canonical A100 classes (1g.5gb, 2g.10gb, 4g.20gb,
7g.40gb) that fits is the tenant's *slice class*.  ``bytes_per_param``
encodes the deployed quantization (0.5 = int4, 1.0 = int8, 2.0 = bf16);
the 1.25× overhead reserves KV-cache/activation headroom.

A tenant's requests are capped-elastic at the class width: a request on a
narrower slice runs slowed by ``class/width``, on a wider slice it gains
nothing (the replica is sized for its class).  Each request's latency SLO
is proportional to its own on-class service time, and its deadline is set
to ``arrival + slo`` so EDF-family schedulers order requests by SLO
urgency unmodified.  SLO attainment is evaluated per tenant in
:class:`~repro_torch.core.metrics.TenantSLOStats` (DESIGN.md §9).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.jobs import Elasticity, ElasticityClass, Job, JobKind, capped
from repro_torch.core.workload import (
    DIURNAL_RATE_PER_MIN,
    MINUTES_PER_DAY,
    arrival_rate,
    sample_poisson_arrivals,
)

__all__ = [
    "SLICE_CLASSES",
    "MEMORY_OVERHEAD",
    "TenantSpec",
    "SERVING_MIXES",
    "serving_mix",
    "model_footprint_gb",
    "model_slice_class",
    "class_elasticity",
    "generate_serving_jobs",
]

#: canonical A100 serving classes: (compute slots, memory GB).  The 3g.20gb
#: class is intentionally absent — it shares its memory with 4g.20gb, so
#: memory-first mapping would never choose it.
SLICE_CLASSES: Tuple[Tuple[int, int], ...] = ((1, 5), (2, 10), (4, 20), (7, 40))

#: KV-cache / activation headroom multiplier over the raw weight footprint
MEMORY_OVERHEAD = 1.25

# mean of the Fig. 5 diurnal envelope (jobs/min): tenant rates are specified
# as day-average rates and modulated by the normalized envelope, so a
# tenant's expected request count over a day is rate_per_min × horizon
_DIURNAL_MEAN = sum(DIURNAL_RATE_PER_MIN) / len(DIURNAL_RATE_PER_MIN)


def model_footprint_gb(model: str, bytes_per_param: float) -> float:
    """Serving memory footprint of a deployed model (GB, with overhead)."""
    params = get_config(model).param_count()
    return params * bytes_per_param * MEMORY_OVERHEAD / 1e9


def model_slice_class(model: str, bytes_per_param: float) -> Tuple[int, int]:
    """Smallest canonical (slots, memory_gb) class that fits the model."""
    need = model_footprint_gb(model, bytes_per_param)
    for slots, mem in SLICE_CLASSES:
        if need <= mem:
            return slots, mem
    raise ValueError(
        f"model {model!r} needs {need:.1f}GB at {bytes_per_param} B/param; "
        f"largest serving class is {SLICE_CLASSES[-1][1]}GB — quantize harder"
    )


@functools.lru_cache(maxsize=None)
def class_elasticity(slots: int) -> Elasticity:
    """Capped elasticity at the tenant's slice-class width.

    The paper's :func:`~repro_torch.core.jobs.capped` only admits the §III-B caps
    {2, 3, 4}; serving classes also need 1 and 7, built directly here with
    the same label convention.  Memoized so every request of a class shares
    one :class:`Elasticity` instance — job streams regenerated for the same
    cell then compare equal (the throughput curve is a lambda; distinct
    instances never would).
    """
    if slots in (2, 3, 4):
        return capped(slots)
    return Elasticity(
        ElasticityClass.CAPPED,
        f"capped@{slots}g",
        lambda k, c=slots: min(k, float(c)),
        cap=slots,
    )


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One serving tenant: a deployed model with traffic and SLO terms.

    ``rate_per_min`` is the tenant's day-average request rate at
    ``load_scale=1`` (the diurnal envelope modulates it around that mean).
    ``mean_service_min`` is the mean request service time *on the tenant's
    slice class*; a request's work is ``service × class_slots`` 1g-minutes.
    ``slo_scale`` multiplies each request's own on-class service time into
    its latency SLO — 2.0 means "finish within 2× your ideal runtime",
    tolerating a sub-class slice or a short queue but not both.
    """

    name: str
    model: str
    bytes_per_param: float
    rate_per_min: float
    mean_service_min: float
    slo_scale: float

    @property
    def slice_class(self) -> Tuple[int, int]:
        return model_slice_class(self.model, self.bytes_per_param)

    @property
    def demand_slots(self) -> int:
        return self.slice_class[0]


#: named tenant mixes for the ``multi-tenant-serving`` scenario.  Rates are
#: normalized so "balanced" offers ~7 1g-min of work per minute at
#: load_scale=1 — about one A100 — and fleet cells scale up from there.
SERVING_MIXES: Dict[str, Tuple[TenantSpec, ...]] = {
    "balanced": (
        TenantSpec("asr-whisper-base", "whisper-base", 1.0, 1.00, 0.5, 4.0),
        TenantSpec("chat-gemma3-1b", "gemma3-1b", 1.0, 0.70, 1.5, 3.0),
        TenantSpec("agent-gemma3-12b", "gemma3-12b", 1.0, 0.22, 3.0, 2.0),
        TenantSpec("synth-mixtral-8x7b", "mixtral-8x7b", 0.5, 0.08, 5.0, 2.0),
    ),
    "small-heavy": (
        TenantSpec("asr-whisper-base", "whisper-base", 1.0, 1.60, 0.5, 4.0),
        TenantSpec("chat-gemma3-1b", "gemma3-1b", 1.0, 1.20, 1.5, 3.0),
        TenantSpec("embed-stablelm-3b", "stablelm-3b", 1.0, 0.80, 2.0, 3.0),
        TenantSpec("agent-gemma3-12b-int4", "gemma3-12b", 0.5, 0.30, 2.5, 2.0),
    ),
    "large-heavy": (
        TenantSpec("chat-gemma3-1b", "gemma3-1b", 1.0, 0.50, 1.5, 3.0),
        TenantSpec("agent-gemma3-12b", "gemma3-12b", 1.0, 0.30, 3.0, 2.0),
        TenantSpec("synth-mixtral-8x7b", "mixtral-8x7b", 0.5, 0.12, 5.0, 2.0),
    ),
}


def serving_mix(name: str) -> Tuple[TenantSpec, ...]:
    """Look up a named tenant mix."""
    try:
        return SERVING_MIXES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown serving mix {name!r}; registered: {sorted(SERVING_MIXES)}"
        ) from e


def generate_serving_jobs(
    seed: int,
    mix: str = "balanced",
    load_scale: float = 1.0,
    slo_mult: float = 1.0,
    horizon_min: float = float(MINUTES_PER_DAY),
) -> List[Job]:
    """Deterministic multi-tenant request stream, sorted by arrival.

    Each tenant draws from an independent RNG stream seeded by
    ``(seed, tenant index)``, so adding a tenant to a mix never perturbs
    the others' draws.  Requests are Poisson over the normalized diurnal
    envelope at the tenant's day-average rate, with exponential on-class
    service times; ``slo_min = slo_scale × slo_mult × service`` and
    ``deadline = arrival + slo_min``.
    """
    tenants = serving_mix(mix)
    all_jobs: List[Job] = []
    for ti, ten in enumerate(tenants):
        rng = np.random.default_rng([seed, 0x5E21, ti])
        mean_rate = ten.rate_per_min * load_scale
        lam_max = mean_rate * max(DIURNAL_RATE_PER_MIN) / _DIURNAL_MEAN

        def rate(t: float, r: float = mean_rate) -> float:
            return r * arrival_rate(t) / _DIURNAL_MEAN

        arrivals = sample_poisson_arrivals(horizon_min, rate, lam_max, rng)
        demand = ten.demand_slots
        elasticity = class_elasticity(demand)
        for a in arrivals:
            service = max(rng.exponential(ten.mean_service_min), 1.0 / 60.0)
            slo = ten.slo_scale * slo_mult * service
            all_jobs.append(
                Job(
                    job_id=0,  # renumbered after the merge sort below
                    kind=JobKind.INFERENCE,
                    arrival=a,
                    work=service * demand,
                    deadline=a + slo,
                    elasticity=elasticity,
                    tenant=ten.name,
                    slo_min=slo,
                )
            )
    all_jobs.sort(key=lambda j: (j.arrival, j.tenant or ""))
    for i, j in enumerate(all_jobs):
        j.job_id = i
    return all_jobs


def _register() -> None:
    # deferred to dodge the scenarios <-> serving import cycle: scenarios
    # imports this module at its bottom, after the registry exists
    from repro_torch.core.scenarios import register_scenario

    @register_scenario(
        "multi-tenant-serving",
        "tenant request streams with latency SLOs; models mapped to MIG "
        "slice classes by memory footprint (DESIGN.md §9)",
        mix="balanced",
        load_scale=1.0,
        slo_mult=1.0,
        horizon_min=float(MINUTES_PER_DAY),
    )
    def _multi_tenant_serving(
        seed: int, mix: str, load_scale: float, slo_mult: float, horizon_min: float
    ) -> List[Job]:
        return generate_serving_jobs(seed, mix, load_scale, slo_mult, horizon_min)


_register()
