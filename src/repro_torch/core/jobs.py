"""Job model: AI/ML workloads with linear / capped / sublinear elasticity.

A job carries ``work``, the duration it would take on a 1g slice.  Its
work-deplete rate on a slice of ``k`` slots is its elasticity's throughput
``tp(k)`` (paper §III-B, Fig. 2):

* linear:     tp(k) = k
* capped(c):  tp(k) = min(k, c)         with c in {2, 3, 4}
* sublinear:  one of four normalized concave curves (two exponential-
              saturating, two logarithmic), tp(1) = 1.

The port's own copy of ``repro.core.jobs``: the job record with its
scheduling state, serving metadata and the laxity helpers the event-driven
schedulers read, its kinds, the curves, and the label codec the service's
WAL records and checkpoints use (:func:`elasticity_from_label`; an
:class:`Elasticity` pickles by its label).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, Optional

from repro_torch.core.slices import ALL_SLICE_SIZES, Partition

__all__ = [
    "JobKind",
    "Elasticity",
    "ElasticityClass",
    "Job",
    "LINEAR",
    "capped",
    "SUBLINEAR_CURVES",
    "sublinear",
    "elasticity_from_label",
]


class JobKind(enum.Enum):
    INFERENCE = "inference"
    TRAINING = "training"  # includes LLM fine-tuning (paper §III-B)


class ElasticityClass(enum.Enum):
    LINEAR = "linear"
    CAPPED = "capped"
    SUBLINEAR = "sublinear"


@dataclasses.dataclass(frozen=True)
class Elasticity:
    """Throughput-vs-slice-size profile. tp(1) == 1 by construction."""

    klass: ElasticityClass
    label: str
    _tp: Callable[[float], float]
    cap: Optional[int] = None  # for CAPPED

    def throughput(self, slots: float) -> float:
        if slots <= 0:
            return 0.0
        return self._tp(float(slots))

    def duration(self, work: float, slots: float) -> float:
        tp = self.throughput(slots)
        if tp <= 0.0:
            return math.inf
        return work / tp

    def __reduce__(self):
        # pickled by label, since ``_tp`` is a lambda: this keeps a Job, and
        # so a whole SimulationEngine, picklable for the service's
        # checkpoints.  The label is resolved now, so a curve outside the
        # vocabulary (the cluster's roofline curves) fails when dumped, not
        # when a checkpoint is restored.
        elasticity_from_label(self.label)
        return (elasticity_from_label, (self.label,))


LINEAR = Elasticity(ElasticityClass.LINEAR, "linear", lambda k: k)


def capped(cap: int) -> Elasticity:
    if cap not in (2, 3, 4):
        raise ValueError(f"paper caps jobs at 2g/3g/4g, got {cap}")
    return Elasticity(
        ElasticityClass.CAPPED, f"capped@{cap}g", lambda k, c=cap: min(k, float(c)), cap=cap
    )


def _exp_curve(a: float) -> Callable[[float], float]:
    # tp(k) = (1 - exp(-a k)) / (1 - exp(-a)); tp(1)=1, concave, saturating.
    denom = 1.0 - math.exp(-a)
    return lambda k: (1.0 - math.exp(-a * k)) / denom


def _log_curve(b: float) -> Callable[[float], float]:
    # tp(k) = 1 + b log2(k); tp(1)=1, concave increasing.
    return lambda k: 1.0 + b * math.log2(k) if k >= 1.0 else k


# Four equally likely sublinear curves (paper §V-A).
SUBLINEAR_CURVES: Dict[str, Elasticity] = {
    "exp-0.35": Elasticity(ElasticityClass.SUBLINEAR, "exp-0.35", _exp_curve(0.35)),
    "exp-0.60": Elasticity(ElasticityClass.SUBLINEAR, "exp-0.60", _exp_curve(0.60)),
    "log-0.65": Elasticity(ElasticityClass.SUBLINEAR, "log-0.65", _log_curve(0.65)),
    "log-0.45": Elasticity(ElasticityClass.SUBLINEAR, "log-0.45", _log_curve(0.45)),
}


def sublinear(label: str) -> Elasticity:
    return SUBLINEAR_CURVES[label]


def elasticity_from_label(label: str) -> Elasticity:
    """Resolve a canonical elasticity label back to its profile.

    The inverse of ``Elasticity.label`` over the whole vocabulary:
    ``"linear"``, ``"capped@<n>g"`` and the four sublinear curve names.  A
    label gives an object with the identical throughput function, so a
    restored job depletes bit-identically.
    """
    if label == "linear":
        return LINEAR
    if label in SUBLINEAR_CURVES:
        return SUBLINEAR_CURVES[label]
    if label.startswith("capped@") and label.endswith("g"):
        cap = int(label[len("capped@"):-1])
        if cap in (2, 3, 4):
            return capped(cap)
        if cap >= 1:
            # the serving slice classes cap at 1 and 7 too, built as
            # repro_torch.core.serving.class_elasticity builds them
            return Elasticity(
                ElasticityClass.CAPPED,
                f"capped@{cap}g",
                lambda k, c=cap: min(k, float(c)),
                cap=cap,
            )
    raise ValueError(
        f"unknown elasticity label {label!r}; valid: 'linear', 'capped@<n>g' "
        f"(n >= 1), or one of {sorted(SUBLINEAR_CURVES)}"
    )


@dataclasses.dataclass
class Job:
    """A single AI/ML job with mutable scheduling state.

    ``work`` is in 1g-slice minutes.  ``remaining`` depletes at rate
    ``elasticity.throughput(slice_slots)`` while running.
    """

    job_id: int
    kind: JobKind
    arrival: float  # minutes
    work: float  # 1g-minutes
    deadline: float  # absolute minutes
    elasticity: Elasticity
    speedup_no_mig: float = 1.0  # NoMIG benchmark: 1.06 for linear jobs

    # --- serving metadata (multi-tenant SLO workloads; DESIGN.md §9) ----
    # Batch jobs leave both None.  A serving request carries its tenant id
    # and a latency SLO in minutes; the generator also sets
    # ``deadline = arrival + slo_min`` so EDF-family schedulers order
    # requests by SLO urgency without modification.
    tenant: Optional[str] = None
    slo_min: Optional[float] = None

    # --- mutable scheduling state -------------------------------------
    remaining: float = dataclasses.field(default=-1.0)
    completion: Optional[float] = None
    preemptions: int = 0
    critical_events: int = 0  # LLF/LALF critical-laxity triggers used
    last_slice: Optional[int] = None  # slice index job last ran on

    def __post_init__(self) -> None:
        if self.remaining < 0.0:
            self.remaining = self.work

    # --- durations ------------------------------------------------------
    def rate_on(self, slots: float, mig_enabled: bool = True) -> float:
        """Work-deplete rate on a slice of given compute size."""
        r = self.elasticity.throughput(slots)
        if not mig_enabled:
            r *= self.speedup_no_mig
        return r

    def duration_on(self, slots: float, mig_enabled: bool = True) -> float:
        r = self.rate_on(slots, mig_enabled)
        return math.inf if r <= 0 else self.remaining / r

    def finish_time_on(self, t: float, slots: float, mig_enabled: bool = True) -> float:
        return t + self.duration_on(slots, mig_enabled)

    def meets_deadline_on(self, t: float, slots: float, mig_enabled: bool = True) -> bool:
        return self.finish_time_on(t, slots, mig_enabled) <= self.deadline + 1e-9

    def laxity_fastest(self, t: float, part: Partition, mig_enabled: bool = True) -> float:
        """Laxity vs the fastest slice of the partition (LLF, paper §IV-C)."""
        fastest = part.slices[part.fastest_slice_index()].slots
        return (self.deadline - t) - self.duration_on(fastest, mig_enabled)

    def laxity_average(self, t: float, part: Partition, mig_enabled: bool = True) -> float:
        """Laxity vs mean duration across the partition's slices (LALF)."""
        durs = [self.duration_on(s.slots, mig_enabled) for s in part.slices]
        return (self.deadline - t) - (sum(durs) / len(durs))

    @property
    def done(self) -> bool:
        return self.remaining <= 1e-9

    def tardiness(self) -> float:
        if self.completion is None:
            return 0.0
        return max(self.completion - self.deadline, 0.0)

    def latency(self) -> float:
        """Arrival-to-completion latency in minutes (0 while incomplete)."""
        if self.completion is None:
            return 0.0
        return max(self.completion - self.arrival, 0.0)

    def slo_attained(self) -> bool:
        """Whether a completed request met its latency SLO.

        Jobs without an SLO trivially attain it; incomplete jobs do not.
        """
        if self.completion is None:
            return False
        if self.slo_min is None:
            return True
        return self.latency() <= self.slo_min + 1e-9

    def mean_duration_all_sizes(self) -> float:
        """Average remaining duration over the canonical slice sizes.

        Used by the DQN state representation ("average duration of the first
        m jobs", paper §IV-D-1) — averaged over slice sizes so it is
        configuration-independent.
        """
        durs = [self.duration_on(k) for k in ALL_SLICE_SIZES]
        return sum(durs) / len(durs)
