"""Sweep-layer glue for the batched backend: group, vectorize, split.

The runner hands this module every pending cell tagged ``backend ==
"batched"``.  Cells are grouped by their physics-minus-seed fingerprint
(same scenario/policy/mode/backend knobs, different seeds) and each group
runs as ONE :func:`repro_torch.core.batched.simulate_batch` call on the
device — seeds become rows of a ``(B, J)`` tensor instead of independent
processes.

The per-cell result dicts come back in the oracle vocabulary
(:func:`repro_torch.sweep.cells._result_dict` fields) so caching, artifacts
and aggregation are backend-agnostic; ``config_trace`` is empty for batched
cells and ``elapsed_s`` divides the group's wall time evenly across its
cells.

Unsupported combinations fail loudly *before* any simulation runs:
schedulers other than EDF-FS, fleet cells, serving cells and policies that
need per-event simulator state all raise :class:`UnsupportedPolicyError`
with a pointer back to the oracle backend.

The port's own copy of ``repro.sweep.batched``, with the port's ``device``
(default: the CUDA card; the CPU only on request).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sweep.cells import (
    Cell,
    canonical_json,
    cell_jobs,
    cell_repartition_mode,
    make_policy,
)

__all__ = [
    "batched_group_key",
    "is_batched_cell",
    "run_batched_cells",
    "validate_batched_cell",
]


def is_batched_cell(cell: Cell) -> bool:
    """True when the cell asks for the batched backend."""
    return cell.get("backend") == "batched"


def batched_group_key(cell: Cell) -> str:
    """Fingerprint of everything but the seed (and grid labels).

    Cells sharing a key are physically identical rollouts under different
    seeds, so they can advance lock-step in one ``simulate_batch`` call.
    """
    skip = ("experiment", "group", "seed")
    return canonical_json({k: v for k, v in cell.items() if k not in skip})


def validate_batched_cell(cell: Cell) -> None:
    """Reject cells the batched backend cannot run, with guidance.

    Raises :class:`repro_torch.core.batched.UnsupportedPolicyError` so
    callers can distinguish "wrong backend for this cell" from genuine
    failures.
    """
    from repro_torch.core.batched import UnsupportedPolicyError

    if "fleet" in cell:
        raise UnsupportedPolicyError(
            "fleet cells need the co-advanced dispatcher loop; "
            "run them on the oracle backend"
        )
    if cell.get("scheduler") != "EDF-FS":
        raise UnsupportedPolicyError(
            f"batched backend implements only EDF-FS "
            f"(got {cell.get('scheduler')!r}); run this cell on the oracle"
        )
    if (cell.get("scenario") or {}).get("name") == "multi-tenant-serving":
        raise UnsupportedPolicyError(
            "serving cells carry per-job tenant/SLO metadata the batched "
            "state arrays do not represent; run them on the oracle backend"
        )


def _resolve_dt(cell: Cell) -> float:
    from repro_torch.core.batched import DEFAULT_DT_MIN

    return float((cell.get("backend_kwargs") or {}).get("dt_min", DEFAULT_DT_MIN))


def run_batched_cells(
    cells: Sequence[Cell], *, device: DeviceLike = None
) -> List[Dict[str, Any]]:
    """Run batched cells grouped by physics on ``device``; results in input order.

    Each group compiles its policy once (:func:`compile_policy` on a fresh
    registry instance, so batched cells honour exactly the defaults oracle
    cells get) and runs one vectorized rollout over its seeds.  ``device``
    defaults to the CUDA card and raises without one.
    """
    from repro_torch.core.batched import (
        BatchedJobs,
        build_tables,
        compile_policy,
        simulate_batch,
    )

    dev = resolve_device(device)
    cells = list(cells)
    groups: Dict[str, List[int]] = {}
    for i, cell in enumerate(cells):
        validate_batched_cell(cell)
        groups.setdefault(batched_group_key(cell), []).append(i)

    tables = build_tables()
    results: List[Dict[str, Any]] = [{} for _ in cells]
    for idx in groups.values():
        # lint: waive[DT002] elapsed_s telemetry; stripped before baseline compare
        t0 = time.perf_counter()
        head = cells[idx[0]]
        job_lists = [cell_jobs(cells[i]) for i in idx]
        jobs = BatchedJobs.from_job_lists(
            job_lists, max_slots=tables.max_slots,
            mig_enabled=head["mig_enabled"],
        )
        policy = compile_policy(
            make_policy(head["policy"], head.get("policy_kwargs"), device=dev),
            tables, batch=len(idx),
        )
        res = simulate_batch(
            jobs, policy, tables=tables,
            repartition_mode=cell_repartition_mode(head),
            dt_min=_resolve_dt(head),
            device=dev,
        )
        elapsed = (time.perf_counter() - t0) / len(idx)  # lint: waive[DT002] telemetry only
        for i, out in zip(idx, res.to_result_dicts(), strict=True):
            out["elapsed_s"] = elapsed
            results[i] = out
    return results
