"""The queue-pressure repartitioning heuristic (the registry's ``"heuristic"``).

The port's own copy of the one part of ``repro.launch.cluster_sim`` that the
policy registry reads: :class:`QueueHeuristicPolicy`.  The TPU-pod day
(``run_days``, ``main``), ``FailureAwarePolicy`` and the pod power curve
``TPU_V5E_POD`` drive the reference's cluster adaptation, which the port does
not have; they are not copied.
"""

from __future__ import annotations

__all__ = ["QueueHeuristicPolicy", "queue_heuristic_policy"]


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
