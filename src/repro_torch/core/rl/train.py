"""Policy evaluation for the repartitioning DQN (paper §V-C), inline.

The port's counterpart of ``repro.core.rl.train.evaluate_policy``: the same
day simulations under a policy, each built as the reference builds its sweep
cell and run through :func:`repro_torch.sweep.cells.run_cell` on the event-
driven simulator, one after another (the reference's sweep engine, cache and
worker processes are not copied).  The host trainer ``train_dqn``
(``backend="oracle"``) and ``evaluate_policy_fleet`` are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.metrics import SimResult
from repro_torch.core.workload import WorkloadSpec
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["evaluate_policy"]


def evaluate_policy(
    policy_factory,
    num_iterations: int = 50,
    spec: Optional[WorkloadSpec] = None,
    scheduler_name: str = "EDF-SS",
    seed: int = 10_000,
    mig_enabled: bool = True,
    scenario: Optional[str] = None,
    scenario_kwargs: Optional[Dict] = None,
    *,
    device: DeviceLike = None,
) -> List[SimResult]:
    """Run ``num_iterations`` independent day simulations under a policy.

    ``policy_factory`` is either a zero-arg callable returning a
    RepartitionPolicy (fresh DQN greedy agents keep per-episode state), or a
    registered policy — a name like ``"heuristic"`` or a ``(name, kwargs)``
    tuple, e.g. ``("dqn", {"params_path": ...})``.  Day ``it`` uses seed
    ``seed + it``; ``scenario`` swaps the :class:`WorkloadSpec` day for a
    registered scenario.  ``device`` is where a registry DQN's Q network runs:
    ``None`` is the CUDA card and raises without one, ``"cpu"`` on request.
    """
    from repro_torch.sweep.cells import make_cell, result_to_sim_result, run_cell

    dev = resolve_device(device)
    spec = spec or WorkloadSpec()
    policy_name, policy_kwargs, factory = _resolve_policy(policy_factory)
    results = []
    for it in range(num_iterations):
        cell = make_cell(
            experiment="evaluate_policy",
            group=policy_name,
            scheduler=scheduler_name,
            seed=seed + it,
            workload=None if scenario is not None else spec,
            scenario=scenario,
            scenario_kwargs=scenario_kwargs,
            policy=policy_name,
            policy_kwargs=policy_kwargs,
            mig_enabled=mig_enabled,
        )
        results.append(result_to_sim_result(run_cell(cell, factory, device=dev)))
    return results


def _resolve_policy(policy_factory):
    """(name, kwargs, ad_hoc_factory) from the evaluate_policy spec forms."""
    if isinstance(policy_factory, str):
        return policy_factory, {}, None
    if isinstance(policy_factory, tuple):
        name, kwargs = policy_factory
        return name, kwargs, None
    return "static", {}, policy_factory  # placeholder name; factory wins
