"""Process-parallel, memoized sweep engine for the paper's experiment grids.

The port's own copy of ``repro.sweep``.  The paper's headline results are
all sweeps — scheduler x config x workload x seed grids pushed through the
event-driven :class:`repro_torch.core.simulator.MIGSimulator`.  This package
turns each of them into a declarative grid of JSON cells (the reference's
cells, hash for hash), fans cells out over worker processes, memoizes
finished cells in a content-addressed on-disk cache, and writes byte-stable
JSONL artifacts for CI to diff.  Batched cells run as one
:func:`repro_torch.core.batched.simulate_batch` per group of seeds.

Quickstart::

    python -m repro_torch.sweep --grid table2_schedulers --workers 4
    python -m repro_torch.sweep --grid smoke --scale 0.1 --workers 2 --device cpu

The registry's ``"dqn"`` and batched cells run on ``device`` (default: the
CUDA card, which every entry point requires unless ``device="cpu"``).  See
:mod:`repro_torch.sweep.grids` for the registry and
:mod:`repro_torch.sweep.runner` for execution semantics.
"""

from repro_torch.sweep.cache import StaleCacheError, SweepCache
from repro_torch.sweep.cells import (
    POLICIES,
    cell_hash,
    cell_jobs,
    cell_repartition_mode,
    group_results,
    make_cell,
    make_fleet_cell,
    make_policy,
    make_scenario_cell,
    result_to_sim_result,
    run_cell,
)
from repro_torch.sweep.grids import (
    GRIDS,
    POLICY_FAMILIES,
    GridDef,
    run_grid,
    summarize_results,
)
from repro_torch.sweep.runner import SweepOutcome, run_cells

__all__ = [
    "GRIDS",
    "POLICIES",
    "POLICY_FAMILIES",
    "GridDef",
    "StaleCacheError",
    "SweepCache",
    "SweepOutcome",
    "cell_hash",
    "cell_jobs",
    "cell_repartition_mode",
    "group_results",
    "make_cell",
    "make_fleet_cell",
    "make_policy",
    "make_scenario_cell",
    "result_to_sim_result",
    "run_cell",
    "run_cells",
    "run_grid",
    "summarize_results",
]
