"""Padded batch containers for the batched backend (numpy).

:class:`BatchedJobs` freezes a ragged list of per-rollout job lists into
rectangular ``(B, J)`` arrays — ``J`` is the max job count rounded up to a
padding multiple.  Padding rows carry ``arrival = +inf`` and ``work = 0`` so
they are never eligible and never accrue anything.  Elasticity curves are
pre-evaluated into ``rate_by_slots[b, j, k]`` (the work-deplete rate of job
``j`` on a ``k``-slot slice, with ``mig_enabled`` folded in).

:class:`BatchedResult` is the host-side mirror of the accumulator carry and
converts back to :class:`repro_torch.core.metrics.SimResult` and to the sweep
layer's result dicts (:meth:`BatchedResult.to_result_dicts`), so aggregation
is backend-agnostic.

The port's own copy of ``repro.core.batched.state``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from repro_torch.core.jobs import Job
from repro_torch.core.metrics import SimResult

__all__ = ["BatchedJobs", "BatchedResult", "PAD_MULTIPLE"]

#: job-axis padding multiple; the backend's EDF rank search works in blocks
#: of this many jobs.
PAD_MULTIPLE = 32

_TARDY_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class BatchedJobs:
    """Rectangular ``(B, J)`` job arrays for a batch of rollouts.

    ``rate_by_slots`` has shape ``(B, J, K)`` with ``K = max_slots + 1``;
    level 0 is always 0.0 (an unassigned job depletes nothing).  ``valid``
    masks padding rows; ``num_jobs`` is the true per-rollout job count.
    """

    arrival: np.ndarray  # (B, J) float32, +inf padded
    deadline: np.ndarray  # (B, J) float32, +inf padded
    work: np.ndarray  # (B, J) float32, 0 padded
    rate_by_slots: np.ndarray  # (B, J, K) float32, 0 padded
    valid: np.ndarray  # (B, J) bool
    num_jobs: np.ndarray  # (B,) int32
    edf_order: np.ndarray  # (B, J) int32 job indices sorted by (deadline, id)

    @property
    def batch(self) -> int:
        """``B`` — number of rollouts advancing lock-step."""
        return int(self.arrival.shape[0])

    @property
    def padded_jobs(self) -> int:
        """``J`` — padded job capacity per rollout."""
        return int(self.arrival.shape[1])

    @classmethod
    def from_job_lists(
        cls,
        job_lists: Sequence[Sequence[Job]],
        *,
        max_slots: int,
        mig_enabled: bool = True,
        pad_multiple: int = PAD_MULTIPLE,
        min_jobs: int = 1,
    ) -> "BatchedJobs":
        """Pad ``B`` ragged job lists into one rectangular container.

        Jobs must be fresh (``remaining == work``).  ``max_slots`` sizes the
        rate table's slot axis (use ``DeviceTables.max_slots``); ``min_jobs``
        floors the padded job axis.
        """
        B = len(job_lists)
        if B == 0:
            raise ValueError("empty batch")
        longest = max((len(js) for js in job_lists), default=0)
        want = max(longest, int(min_jobs), 1)
        J = max(pad_multiple, -(-want // pad_multiple) * pad_multiple)
        K = max_slots + 1

        arrival = np.full((B, J), np.inf, dtype=np.float32)
        deadline = np.full((B, J), np.inf, dtype=np.float32)
        work = np.zeros((B, J), dtype=np.float32)
        rates = np.zeros((B, J, K), dtype=np.float32)
        valid = np.zeros((B, J), dtype=bool)
        num_jobs = np.zeros((B,), dtype=np.int32)

        for b, jobs in enumerate(job_lists):
            num_jobs[b] = len(jobs)
            for j, job in enumerate(jobs):
                if abs(job.remaining - job.work) > 1e-9:
                    raise ValueError(
                        f"rollout {b} job {job.job_id}: partially-run jobs "
                        "cannot enter a batched rollout"
                    )
                arrival[b, j] = job.arrival
                deadline[b, j] = job.deadline
                work[b, j] = job.work
                valid[b, j] = True
                for k in range(1, K):
                    rates[b, j, k] = job.rate_on(float(k), mig_enabled)
        # deadlines are static, so EDF order is too; the stable sort keeps
        # the (deadline, arrival, job_id) tie-break, since job ids are
        # arrival-ordered
        edf_order = np.argsort(deadline, axis=1, kind="stable").astype(np.int32)
        return cls(
            arrival=arrival,
            deadline=deadline,
            work=work,
            rate_by_slots=rates,
            valid=valid,
            num_jobs=num_jobs,
            edf_order=edf_order,
        )


@dataclasses.dataclass(frozen=True)
class BatchedResult:
    """Per-rollout aggregates of one ``simulate_batch`` call (numpy).

    Mirrors :class:`SimResult`'s fields plus the utilization histogram;
    ``completion`` keeps the exact per-job finish times (``+inf`` for
    padding rows).
    """

    energy_wh: np.ndarray  # (B,) float64
    tardiness_integral: np.ndarray  # (B,) float64
    busy_slot_minutes: np.ndarray  # (B,) float64
    preemptions: np.ndarray  # (B,) int64
    repartitions: np.ndarray  # (B,) int64
    completion: np.ndarray  # (B, J) float64, +inf on padding
    deadline: np.ndarray  # (B, J) float64
    valid: np.ndarray  # (B, J) bool
    num_jobs: np.ndarray  # (B,) int64
    makespan_min: np.ndarray  # (B,) float64
    util_histogram: np.ndarray  # (B, K) float64 minutes at each busy level

    @property
    def batch(self) -> int:
        """``B`` — rollout count."""
        return int(self.energy_wh.shape[0])

    def _tardiness(self, b: int) -> np.ndarray:
        mask = self.valid[b]
        tardy = self.completion[b, mask] - self.deadline[b, mask]
        return np.maximum(tardy, 0.0)

    def to_sim_result(self, b: int) -> SimResult:
        """Rollout ``b`` as a :class:`SimResult`."""
        tardy = self._tardiness(b)
        n = int(self.num_jobs[b])
        total = float(tardy.sum())
        return SimResult(
            energy_wh=float(self.energy_wh[b]),
            avg_tardiness=total / max(n, 1),
            num_jobs=n,
            total_tardiness=total,
            preemptions=int(self.preemptions[b]),
            repartitions=int(self.repartitions[b]),
            max_tardiness=float(tardy.max()) if tardy.size else 0.0,
            deadline_misses=int((tardy > _TARDY_EPS).sum()),
            busy_slot_minutes=float(self.busy_slot_minutes[b]),
            extra={
                "makespan_min": float(self.makespan_min[b]),
                "tardiness_integral": float(self.tardiness_integral[b]),
            },
        )

    def to_sim_results(self) -> List[SimResult]:
        """All rollouts as :class:`SimResult`, batch order preserved."""
        return [self.to_sim_result(b) for b in range(self.batch)]

    def to_result_dicts(self) -> List[Dict[str, Any]]:
        """Sweep-layer result dicts (the ``run_cell`` vocabulary).

        ``util_histogram`` keeps the busy levels with minutes above 0;
        ``config_trace`` is empty — like fleet cells, batched cells do not
        record the per-rollout switch trace.
        """
        out: List[Dict[str, Any]] = []
        for b, res in enumerate(self.to_sim_results()):
            hist = {
                str(k): float(v)
                for k, v in enumerate(self.util_histogram[b])
                if v > 0.0
            }
            out.append(
                {
                    "energy_wh": res.energy_wh,
                    "avg_tardiness": res.avg_tardiness,
                    "num_jobs": res.num_jobs,
                    "total_tardiness": res.total_tardiness,
                    "preemptions": res.preemptions,
                    "repartitions": res.repartitions,
                    "max_tardiness": res.max_tardiness,
                    "deadline_misses": res.deadline_misses,
                    "busy_slot_minutes": res.busy_slot_minutes,
                    "extra": dict(res.extra),
                    "util_histogram": hist,
                    "config_trace": [],
                }
            )
        return out
