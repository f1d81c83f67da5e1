"""In-configuration preemptive scheduling algorithms (paper §IV-C).

All schedulers produce, at each preemption point (arrival / completion /
critical-laxity event), a full assignment of active jobs to slices of the
current partition.  The simulator diffs consecutive assignments to count
preemptions (a previously running job that is paused or moved).

Algorithms (paper numbering):
  1. EDF-FS  — Earliest Deadline First, Fastest Slice.
  2. EDF-SS  — Earliest Deadline First, Slowest Slice that meets the deadline
               (fastest slice if none does).  ``restricted=True`` gives the
               variant that only preempts to directly prevent deadline misses
               (Fig. 4); the paper proceeds with the restricted variant.
  3. LLF     — Least Laxity First (laxity vs fastest slice), fastest slice,
               with critical-laxity events.
  4. LALF    — Least *Average* Laxity First (laxity vs mean duration across
               slices), fastest slice, with critical-laxity events.

The port's own copy of ``repro.core.schedulers``, whole.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.jobs import Job
from repro_torch.core.slices import Partition

__all__ = [
    "Assignment",
    "Scheduler",
    "EDFFastestSlice",
    "EDFSlowestSlice",
    "LeastLaxityFirst",
    "LeastAverageLaxityFirst",
    "make_scheduler",
    "remap_assignment",
    "SCHEDULERS",
]

# job_id -> slice index within the current partition
Assignment = Dict[int, int]


def remap_assignment(
    current: Assignment, index_map: Mapping[int, int]
) -> Assignment:
    """Carry an assignment across a partition change, slice-identity-stable.

    ``index_map`` maps old slice indices to their new indices for slice
    instances that survive a partial repartition
    (:class:`repro_torch.core.slices.TransitionPlan`).  Jobs on surviving slices
    keep their seat under the new numbering; jobs on non-surviving slices
    must already have been preempted (asserted here — a silent drop would
    hide a simulator accounting bug).  Preserves iteration order, so the
    preemption diff in ``MIGSimulator._apply_assignment`` stays stable.
    """
    out: Assignment = {}
    for jid, old_slice in current.items():
        if old_slice not in index_map:
            raise AssertionError(
                f"job {jid} still assigned to non-surviving slice {old_slice}"
            )
        out[jid] = index_map[old_slice]
    return out


def _edf_key(job: Job) -> Tuple[float, float, int]:
    return (job.deadline, job.arrival, job.job_id)


class Scheduler(ABC):
    """Base class. Subclasses implement :meth:`assign`."""

    name: str = "base"
    uses_critical_laxity: bool = False
    critical_laxity_threshold: float = 1.0  # paper §V-A
    max_critical_preemptions: int = 3  # paper §V-A

    @abstractmethod
    def assign(
        self,
        t: float,
        part: Partition,
        jobs: Sequence[Job],
        current: Assignment,
        mig_enabled: bool = True,
    ) -> Assignment:
        """Return the new assignment for all active (not done) jobs."""

    # -- critical-laxity support (LLF/LALF) ------------------------------
    def job_laxity(self, t: float, part: Partition, job: Job, mig: bool = True) -> float:
        return job.laxity_fastest(t, part, mig)

    def next_critical_time(
        self,
        t: float,
        part: Partition,
        jobs: Sequence[Job],
        current: Assignment,
        mig_enabled: bool = True,
    ) -> Optional[float]:
        """Earliest future time a WAITING job's laxity crosses the threshold.

        While waiting, remaining duration is constant, so laxity decreases at
        unit rate: crossing time = t + (laxity(t) - threshold).
        """
        if not self.uses_critical_laxity:
            return None
        best: Optional[float] = None
        for job in jobs:
            if job.done or job.job_id in current:
                continue
            if job.critical_events >= self.max_critical_preemptions:
                continue
            lax = self.job_laxity(t, part, job, mig_enabled)
            if not math.isfinite(lax):
                continue
            dt = lax - self.critical_laxity_threshold
            if dt <= 1e-9:
                continue  # already critical; handled at this event
            cand = t + dt
            if best is None or cand < best:
                best = cand
        return best


def _greedy_fastest(
    t: float, part: Partition, ordered_jobs: Sequence[Job], mig: bool
) -> Assignment:
    """Assign jobs (in priority order) each to the fastest free slice."""
    free = part.sorted_indices(descending=True)  # fastest first
    out: Assignment = {}
    for job in ordered_jobs:
        if not free:
            break
        out[job.job_id] = free.pop(0)
    return out


class EDFFastestSlice(Scheduler):
    name = "EDF-FS"

    def assign(self, t, part, jobs, current, mig_enabled=True):
        active = sorted((j for j in jobs if not j.done), key=_edf_key)
        return _greedy_fastest(t, part, active, mig_enabled)


class EDFSlowestSlice(Scheduler):
    """EDF-SS; ``restricted=True`` => deadline-critical preemptions only."""

    def __init__(self, restricted: bool = True) -> None:
        self.restricted = restricted
        self.name = "EDF-SS" if restricted else "EDF-SS-unrestricted"

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _slowest_feasible(
        t: float, part: Partition, job: Job, free: List[int], mig: bool
    ) -> Optional[int]:
        """Slowest free slice meeting the deadline; None if none does."""
        feasible = [
            i for i in free if job.meets_deadline_on(t, part.slices[i].slots, mig)
        ]
        if not feasible:
            return None
        return min(feasible, key=lambda i: (part.slices[i].slots, i))

    @staticmethod
    def _fastest(part: Partition, free: List[int]) -> Optional[int]:
        if not free:
            return None
        return max(free, key=lambda i: (part.slices[i].slots, -i))

    # -- unrestricted: full reassignment ----------------------------------
    def _assign_unrestricted(self, t, part, jobs, mig) -> Assignment:
        active = sorted((j for j in jobs if not j.done), key=_edf_key)
        free = list(range(part.num_slices))
        out: Assignment = {}
        for job in active:
            if not free:
                break
            pick = self._slowest_feasible(t, part, job, free, mig)
            if pick is None:
                pick = self._fastest(part, free)
            out[job.job_id] = pick  # type: ignore[assignment]
            free.remove(pick)  # type: ignore[arg-type]
        return out

    # -- restricted: keep running jobs unless a deadline is at stake ------
    def _assign_restricted(self, t, part, jobs, current, mig) -> Assignment:
        by_id = {j.job_id: j for j in jobs if not j.done}
        out: Assignment = {
            jid: s for jid, s in current.items() if jid in by_id
        }
        free = [i for i in range(part.num_slices) if i not in out.values()]

        # Step A: a running job that now misses its deadline on its own slice
        # may (i) migrate to a free slice that saves it (slowest such),
        # (ii) displace a later-deadline runner whose slice saves it (the
        # victim re-queues into Step B), or (iii) as a last resort take a
        # strictly faster free slice (the EDF-SS "fastest slice" rule for
        # infeasible jobs).  All three directly prevent/reduce deadline
        # misses — the Fig. 4 restriction criterion.
        displaced: List[int] = []
        for jid in sorted(out, key=lambda j: _edf_key(by_id[j])):
            if jid not in out:  # displaced by an earlier iteration
                continue
            job = by_id[jid]
            cur_slice = out[jid]
            if job.meets_deadline_on(t, part.slices[cur_slice].slots, mig):
                continue
            pick = self._slowest_feasible(t, part, job, free, mig)
            if pick is None:
                victims = [
                    (vj, s)
                    for vj, s in out.items()
                    if vj != jid
                    and by_id[vj].deadline > job.deadline
                    and job.meets_deadline_on(t, part.slices[s].slots, mig)
                ]
                if victims:
                    vjid, vslice = min(
                        victims,
                        key=lambda pr: (part.slices[pr[1]].slots, -by_id[pr[0]].deadline),
                    )
                    del out[vjid]
                    displaced.append(vjid)
                    free.append(cur_slice)
                    out[jid] = vslice
                    continue
            if pick is None:
                fastest_free = self._fastest(part, free)
                if (
                    fastest_free is not None
                    and part.slices[fastest_free].slots
                    > part.slices[cur_slice].slots
                ):
                    pick = fastest_free
            if pick is not None:
                free.append(cur_slice)
                free.remove(pick)
                out[jid] = pick

        # Step B: queued jobs in EDF order.
        queued = sorted(
            (j for j in by_id.values() if j.job_id not in out), key=_edf_key
        )
        pending = list(queued)
        while pending:
            job = pending.pop(0)
            pick = self._slowest_feasible(t, part, job, free, mig)
            if pick is not None:
                out[job.job_id] = pick
                free.remove(pick)
                continue
            # No free slice meets the deadline. Preempt a later-deadline
            # running job ONLY if that directly saves this job's deadline.
            victims = [
                (jid, s)
                for jid, s in out.items()
                if by_id[jid].deadline > job.deadline
                and job.meets_deadline_on(t, part.slices[s].slots, mig)
            ]
            if victims:
                # Prefer the slowest slice that still saves the job; break
                # ties by latest victim deadline (most laxity to give up).
                vjid, vslice = min(
                    victims,
                    key=lambda p: (part.slices[p[1]].slots, -by_id[p[0]].deadline),
                )
                del out[vjid]
                out[job.job_id] = vslice
                # victim re-queues and is reconsidered for remaining slices
                pending.append(by_id[vjid])
                pending.sort(key=_edf_key)
                continue
            # Deadline unsalvageable: take the fastest free slice if any.
            pick = self._fastest(part, free)
            if pick is not None:
                out[job.job_id] = pick
                free.remove(pick)
        return out

    def assign(self, t, part, jobs, current, mig_enabled=True):
        if self.restricted:
            return self._assign_restricted(t, part, jobs, current, mig_enabled)
        return self._assign_unrestricted(t, part, jobs, mig_enabled)


class LeastLaxityFirst(Scheduler):
    """LLF — laxity vs the fastest slice; jobs run on fastest slices."""

    name = "LLF"
    uses_critical_laxity = True

    def job_laxity(self, t, part, job, mig=True):
        return job.laxity_fastest(t, part, mig)

    def assign(self, t, part, jobs, current, mig_enabled=True):
        active = [j for j in jobs if not j.done]
        active.sort(
            key=lambda j: (self.job_laxity(t, part, j, mig_enabled), j.arrival, j.job_id)
        )
        return _greedy_fastest(t, part, active, mig_enabled)


class LeastAverageLaxityFirst(LeastLaxityFirst):
    """LALF — laxity vs mean duration across the partition's slices."""

    name = "LALF"
    uses_critical_laxity = True

    def job_laxity(self, t, part, job, mig=True):
        return job.laxity_average(t, part, mig)


SCHEDULERS = {
    "EDF-FS": lambda: EDFFastestSlice(),
    "EDF-SS": lambda: EDFSlowestSlice(restricted=True),
    "EDF-SS-unrestricted": lambda: EDFSlowestSlice(restricted=False),
    "LLF": lambda: LeastLaxityFirst(),
    "LALF": lambda: LeastAverageLaxityFirst(),
}


def make_scheduler(name: str) -> Scheduler:
    try:
        return SCHEDULERS[name]()
    except KeyError as e:
        raise KeyError(f"unknown scheduler {name!r}; options {sorted(SCHEDULERS)}") from e
