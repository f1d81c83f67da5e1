"""Sweep cells on the port's event-driven simulator (the reference's oracle path).

:mod:`repro_torch.sweep.cells` holds the policy registry and runs one cell
inline; the reference's sweep engine (hashes, cache, workers, grids) is not
copied.
"""

from repro_torch.sweep.cells import (
    POLICIES,
    cell_jobs,
    cell_repartition_mode,
    make_cell,
    make_policy,
    result_to_sim_result,
    run_cell,
)

__all__ = [
    "POLICIES",
    "cell_jobs",
    "cell_repartition_mode",
    "make_cell",
    "make_policy",
    "result_to_sim_result",
    "run_cell",
]
