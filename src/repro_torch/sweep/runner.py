"""The parallel sweep runner: cache lookup, process fan-out, JSONL artifacts.

Execution model
---------------
* Every cell gets a content hash; memoized results are served from the
  :class:`SweepCache` (the ``--resume`` path — an interrupted sweep re-runs
  only missing cells because each result is persisted as it arrives).
* Batched-backend cells run in the parent process, one
  :func:`repro_torch.core.batched.simulate_batch` call per group of seeds on
  the device (:mod:`repro_torch.sweep.batched`).
* The other misses run through ``run_cell`` — inline for ``workers <= 1``,
  else fanned out over a ``spawn`` ``ProcessPoolExecutor``.  Determinism
  does not depend on the worker count: a cell's seed travels inside the
  cell, and results are put back into grid order before
  aggregation/serialization.
* The artifact is a byte-stable JSONL file under ``artifacts/sweeps/`` (one
  ``{hash, cell, result}`` line per cell, canonical JSON) — CI diffs it
  against a checked-in baseline.  Wall-clock/cache metadata goes to a
  sidecar ``.meta.json`` so it never perturbs the diff.

``device`` (default: the CUDA card; raises without one, the CPU only on
request) is resolved once here, so a machine without a card fails before any
worker starts; workers get it as a string.  They import torch, run it on one
thread each, and open CUDA only for a cell that runs on the device (the
registry's ``"dqn"``).

The port's own copy of ``repro.sweep.runner``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sweep.cache import DEFAULT_CACHE_DIR, SweepCache
from repro_torch.sweep.cells import Cell, canonical_json, cell_hash, run_cell

__all__ = ["SweepOutcome", "run_cells", "DEFAULT_ARTIFACTS_DIR"]

DEFAULT_ARTIFACTS_DIR = os.path.join("artifacts", "sweeps")


@dataclasses.dataclass
class SweepOutcome:
    """Everything one ``run_cells`` call produced, in grid order."""

    name: str
    cells: List[Cell]
    hashes: List[str]
    results: List[Dict[str, Any]]  # grid order, parallel to ``cells``
    cached_count: int
    computed_count: int
    wall_s: float
    jsonl_path: Optional[str]

    @property
    def total(self) -> int:
        """Total cell count (cached + computed)."""
        return len(self.cells)


def _strip_volatile(result: Dict[str, Any]) -> Dict[str, Any]:
    """Drop wall-clock noise so artifacts/cache entries diff cleanly."""
    return {k: v for k, v in result.items() if k != "elapsed_s"}


def _init_worker() -> None:
    """One torch thread a worker process: the pool's processes share the
    cores, and torch's default of one thread a core in each of them makes a
    CPU Q network's small products contend for every core at once."""
    import torch

    torch.set_num_threads(1)


def run_cells(
    name: str,
    cells: Sequence[Cell],
    *,
    workers: int = 0,
    cache: Union[SweepCache, str, None, bool] = True,
    resume: bool = True,
    artifacts_dir: Optional[str] = DEFAULT_ARTIFACTS_DIR,
    policy_factory: Optional[Callable[[], Any]] = None,
    progress: Optional[Callable[[str], None]] = None,
    device: DeviceLike = None,
) -> SweepOutcome:
    """Run a grid of cells; returns results in grid order.

    ``cache``: True -> default dir, a str -> that dir, a SweepCache -> as-is,
    False/None -> no memoization.  ``resume=False`` ignores existing entries
    (recompute everything) but still persists fresh results.

    ``policy_factory`` forces inline execution with an ad-hoc policy and
    bypasses the cache entirely: an arbitrary closure is neither picklable
    nor content-addressable.
    """
    dev = resolve_device(device)
    if isinstance(cache, bool):
        cache_obj = SweepCache(DEFAULT_CACHE_DIR) if cache else None
    elif isinstance(cache, str):
        cache_obj = SweepCache(cache)
    else:
        cache_obj = cache
    if policy_factory is not None:
        cache_obj = None

    if cache_obj is not None and resume:
        # refuse to resume over a cache written under a different SIM_VERSION
        # (raises StaleCacheError) — silent semantics-mixing is the one
        # failure mode a content-addressed cache cannot flag per-cell
        cache_obj.check_version()

    t0 = time.perf_counter()  # lint: waive[DT002] meta.json wall_s telemetry only
    cells = list(cells)
    hashes = [cell_hash(c) for c in cells]
    results: List[Optional[Dict[str, Any]]] = [None] * len(cells)

    cached_count = 0
    pending: List[int] = []
    for i, h in enumerate(hashes):
        hit = cache_obj.get(h) if (cache_obj is not None and resume) else None
        if hit is not None:
            results[i] = hit
            cached_count += 1
        else:
            pending.append(i)

    if progress and cells:
        progress(
            f"[{name}] {len(cells)} cells: {cached_count} cached, "
            f"{len(pending)} to compute (workers={max(workers, 1)})"
        )
    computed_count = len(pending)

    # batched-backend cells never enter the worker pool: grouping seeds into
    # one vectorized simulate_batch call on the device *is* their
    # parallelism.  (with an ad-hoc policy_factory they fall through to
    # run_cell, which rejects the combination with a useful error.)
    batched = [
        i for i in pending if cells[i].get("backend") == "batched"
    ] if policy_factory is None else []
    if batched:
        from repro_torch.sweep.batched import run_batched_cells

        if progress:
            progress(f"[{name}] {len(batched)} batched cells run in-process")
        raws = run_batched_cells([cells[i] for i in batched], device=dev)
        for i, raw in zip(batched, raws, strict=True):
            out = _strip_volatile(raw)
            results[i] = out
            if cache_obj is not None:
                cache_obj.put(hashes[i], cells[i], out)
        done_batched = set(batched)
        pending = [i for i in pending if i not in done_batched]

    if pending:
        if policy_factory is not None or workers <= 1:
            for i in pending:
                out = _strip_volatile(run_cell(cells[i], policy_factory, device=dev))
                results[i] = out
                if cache_obj is not None:
                    cache_obj.put(hashes[i], cells[i], out)
        else:
            max_workers = min(workers, os.cpu_count() or workers, len(pending))
            # spawn, not fork: the parent may hold CUDA and torch's thread
            # pools, and forking a multithreaded process can deadlock
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(
                max_workers=max_workers, mp_context=ctx, initializer=_init_worker
            ) as ex:
                futs = {
                    ex.submit(run_cell, cells[i], device=str(dev)): i for i in pending
                }
                done = 0
                for fut in concurrent.futures.as_completed(futs):
                    i = futs[fut]
                    try:
                        out = _strip_volatile(fut.result())
                    except Exception as e:
                        raise RuntimeError(
                            f"sweep cell failed: {canonical_json(cells[i])}"
                        ) from e
                    results[i] = out
                    if cache_obj is not None:
                        cache_obj.put(hashes[i], cells[i], out)
                    done += 1
                    if progress and done % 50 == 0:
                        progress(f"[{name}] {done}/{len(pending)} computed")

    jsonl_path = None
    if artifacts_dir is not None:
        os.makedirs(artifacts_dir, exist_ok=True)
        jsonl_path = os.path.join(artifacts_dir, f"{name}.jsonl")
        tmp = jsonl_path + ".tmp"
        with open(tmp, "w") as f:
            for h, cell, result in zip(hashes, cells, results, strict=True):
                f.write(canonical_json({"hash": h, "cell": cell, "result": result}))
                f.write("\n")
        os.replace(tmp, jsonl_path)
        wall_s = time.perf_counter() - t0  # lint: waive[DT002] meta.json telemetry only
        with open(os.path.join(artifacts_dir, f"{name}.meta.json"), "w") as f:
            json.dump(
                {
                    "name": name,
                    "cells": len(cells),
                    "cached": cached_count,
                    "computed": computed_count,
                    "workers": workers,
                    "wall_s": wall_s,
                },
                f,
                indent=2,
            )
    else:
        wall_s = time.perf_counter() - t0  # lint: waive[DT002] meta.json telemetry only

    return SweepOutcome(
        name=name,
        cells=cells,
        hashes=hashes,
        results=results,  # type: ignore[arg-type]
        cached_count=cached_count,
        computed_count=computed_count,
        wall_s=wall_s,
        jsonl_path=jsonl_path,
    )
