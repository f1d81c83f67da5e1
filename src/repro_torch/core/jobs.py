"""Job model: AI/ML workloads with linear / capped / sublinear elasticity.

A job carries ``work``, the duration it would take on a 1g slice.  Its
work-deplete rate on a slice of ``k`` slots is its elasticity's throughput
``tp(k)`` (paper §III-B, Fig. 2):

* linear:     tp(k) = k
* capped(c):  tp(k) = min(k, c)         with c in {2, 3, 4}
* sublinear:  one of four normalized concave curves (two exponential-
              saturating, two logarithmic), tp(1) = 1.

The port's own copy of ``repro.core.jobs`` with what the batched simulator
reads: the job record, its kinds, the curves and ``rate_on``.  The laxity
helpers of the event-driven schedulers, the serving metadata and the label
codec of the service's checkpoints are not copied.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, Optional

__all__ = [
    "JobKind",
    "Elasticity",
    "ElasticityClass",
    "Job",
    "LINEAR",
    "capped",
    "SUBLINEAR_CURVES",
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


@dataclasses.dataclass
class Job:
    """A single AI/ML job.

    ``work`` is in 1g-slice minutes; ``remaining`` starts equal to it (the
    batched simulator takes only fresh jobs and keeps depletion itself).
    """

    job_id: int
    kind: JobKind
    arrival: float  # minutes
    work: float  # 1g-minutes
    deadline: float  # absolute minutes
    elasticity: Elasticity
    speedup_no_mig: float = 1.0  # NoMIG benchmark: 1.06 for linear jobs
    remaining: float = dataclasses.field(default=-1.0)

    def __post_init__(self) -> None:
        if self.remaining < 0.0:
            self.remaining = self.work

    def rate_on(self, slots: float, mig_enabled: bool = True) -> float:
        """Work-deplete rate on a slice of given compute size."""
        r = self.elasticity.throughput(slots)
        if not mig_enabled:
            r *= self.speedup_no_mig
        return r
