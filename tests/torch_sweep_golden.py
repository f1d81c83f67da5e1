"""The inputs of ``tests/data/torch_sweep_golden.json`` and the comparisons it is read with.

The golden file holds what the JAX package's sweep engine gives (written by
``tests/test_torch_sweep.py --write-golden``):

* the seven paper grids (Table II, Figs. 4, 6, 7-8, 9-10, Table III, Fig. 11)
  at ``--scale 1.0``: per grid the cell count, a digest of the cell hashes
  and the aggregate rows; once without ``artifacts/dqn_params.npz`` in the
  working directory and once with the checked-in
  ``benchmarks/baselines/rl_dqn_params.npz`` copied there, which adds the
  DQN row to Table III and switches Fig. 11 to the DQN (the other five grids
  do not read the file);
* the batched route: static config 3, nomig and daynight, 64 seeds each, of
  ``paper-diurnal`` under EDF-FS as batched cells (three ``simulate_batch``
  groups), each cell's result dict.

This module builds the same inputs with either package's constructors and
holds results to the golden file, and imports nothing of JAX, so the CPU
tests and ``chip_smoke.py`` (on a machine without JAX) share one copy.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Sequence

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_sweep_golden.json"
RL_PARAMS = ROOT / "benchmarks" / "baselines" / "rl_dqn_params.npz"
DQN_PARAMS_PATH = os.path.join("artifacts", "dqn_params.npz")

PAPER_GRIDS = ("table2_schedulers", "fig4_preemption", "fig6_utilization", "fig7_fig8_arrival",
               "fig9_fig10_split", "table3_repartitioning", "fig11_preferences")
# the grids whose cells change when artifacts/dqn_params.npz exists
DQN_GRIDS = ("table3_repartitioning", "fig11_preferences")
SCALE = 1.0
# the reference's --check-baseline tolerance, for the aggregate rows
ROWS_RTOL = 1e-9

# the batched route's cells: (group, policy, policy_kwargs, mig_enabled), as
# the grids' policy families spell them, each over BATCHED_SEEDS
BATCHED_POLICIES = (
    ("StaticMIG", "static", {"config_id": 3}, True),
    ("NoMIG", "nomig", None, False),
    ("DayNightMIG", "daynight", None, True),
)
BATCHED_SEEDS = range(64)

# port against reference, the same batched cells (tests/test_torch_sim.py's
# bars): integers exact; energy and busy 1e-5 relative; the tardiness
# integral 1e-4 relative or 1e-3 absolute; minutes (makespan, each job's
# completion, so the per-job tardiness means and maxima) and the histogram's
# minutes 1e-3 absolute; the tardiness sum 1e-3 a job
BATCHED_EXACT = ("num_jobs", "preemptions", "repartitions", "deadline_misses")
BATCHED_RTOL = {"energy_wh": 1e-5, "busy_slot_minutes": 1e-5}
TARD_RTOL, MINUTES_ATOL = 1e-4, 1e-3

# against the event-driven oracle (BATCHED_SIM.md §4, tests/test_torch_sim.py)
ENERGY_RTOL = 0.03
TARDINESS_ATOL_MIN = 0.15  # minutes of avg tardiness, OR ...
TARDINESS_RTOL = 0.5  # ... relative to max(oracle, TARDINESS_FLOOR)
TARDINESS_FLOOR = 0.25
BUSY_RTOL = 0.025
PREEMPTIONS_RTOL = 0.4  # relative to max(oracle, PREEMPTIONS_FLOOR)
PREEMPTIONS_FLOOR = 10.0


def hash_digest(hashes: Sequence[str]) -> str:
    """One digest for a grid's cell hashes, in grid order."""
    return hashlib.sha256("\n".join(hashes).encode()).hexdigest()


@contextlib.contextmanager
def working_dir(dqn: bool = False) -> Iterator[str]:
    """A fresh temporary working directory, removed afterwards; with ``dqn``
    the checked-in parameters are copied to ``artifacts/dqn_params.npz`` in
    it, as the grids look for them. Caches and artifacts land there too."""
    prev = os.getcwd()
    path = tempfile.mkdtemp(prefix="sweep-")
    try:
        os.chdir(path)
        if dqn:
            os.makedirs("artifacts")
            shutil.copyfile(RL_PARAMS, DQN_PARAMS_PATH)
        yield path
    finally:
        os.chdir(prev)
        shutil.rmtree(path, ignore_errors=True)


def run_paper(run_grid: Callable, grids: Sequence[str], scale: float = SCALE,
              **kwargs: Any) -> Dict[str, Dict[str, Any]]:
    """``run_grid`` (either package's) on each grid in the working directory:
    the cell count, the hash digest, the rows and the seconds."""
    out = {}
    for name in grids:
        t0 = time.perf_counter()
        rows, outcome = run_grid(name, scale=scale, **kwargs)
        out[name] = {"cells": outcome.total, "hashes": hash_digest(outcome.hashes),
                     "rows": rows, "computed": outcome.computed_count,
                     "seconds": time.perf_counter() - t0}
    return out


def _close(a: Any, b: Any, rtol: float) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return False
        fa, fb = float(a), float(b)
        return abs(fa - fb) <= rtol * max(abs(fa), abs(fb), 1.0)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol) for k in a)
    return type(a) is type(b) and a == b


def rows_off(got: Sequence[Dict[str, Any]], want: Sequence[Dict[str, Any]],
             rtol: float = ROWS_RTOL) -> List[Dict[str, Any]]:
    """Where aggregate rows differ: floats beyond ``rtol`` of the larger
    magnitude (at least 1), anything else not equal (integers exactly)."""
    if len(got) != len(want):
        return [{"rows": [len(got), len(want)]}]
    off = []
    for i, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w):
            off.append({"row": i, "keys": [list(g), list(w)]})
            continue
        off += [{"row": i, "key": k, "got": g[k], "want": w[k]}
                for k in g if not _close(g[k], w[k], rtol)]
    return off


def rows_max_rel(got: Dict[str, Dict[str, Any]], want: Dict[str, Dict[str, Any]]) -> float:
    """The largest ``|a - b| / max(|a|, |b|, 1)`` over the float cells of the
    grids' rows (rows of equal shape)."""
    worst = 0.0
    for name, g in got.items():
        for gr, wr in zip(g["rows"], want[name]["rows"]):
            for k, a in gr.items():
                b = wr.get(k)
                if isinstance(a, float) and isinstance(b, float):
                    worst = max(worst, abs(a - b) / max(abs(a), abs(b), 1.0))
    return worst


def paper_off(got: Dict[str, Dict[str, Any]], want: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Per grid, what differs from the golden file's: cells, hashes, rows."""
    off = {}
    for name, g in got.items():
        w = want[name]
        bad = rows_off(g["rows"], w["rows"])
        if g["cells"] != w["cells"] or g["hashes"] != w["hashes"] or bad:
            off[name] = {"cells": [g["cells"], w["cells"]], "hashes_equal": g["hashes"] == w["hashes"],
                         "rows_off": bad[:8]}
    return off


def batched_cells(make_scenario_cell: Callable) -> List[Dict]:
    """The batched route's cells, built by either package's constructor."""
    return [
        make_scenario_cell(experiment="sweep_batched", group=group, scheduler="EDF-FS",
                           scenario="paper-diurnal", seed=s, policy=policy,
                           policy_kwargs=kwargs, mig_enabled=mig, backend="batched")
        for group, policy, kwargs, mig in BATCHED_POLICIES
        for s in BATCHED_SEEDS
    ]


def _abs_ok(a: float, b: float, atol: float, rtol: float = 0.0) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def batched_off(got: Dict[str, Any], want: Dict[str, Any]) -> List[str]:
    """The fields of a batched result dict outside the port-vs-reference bars."""
    bad = [k for k in BATCHED_EXACT if got[k] != want[k]]
    bad += [k for k, rtol in BATCHED_RTOL.items() if not _abs_ok(got[k], want[k], 0.0, rtol)]
    n = max(want["num_jobs"], 1)
    for k, atol in (("avg_tardiness", MINUTES_ATOL), ("max_tardiness", MINUTES_ATOL),
                    ("total_tardiness", MINUTES_ATOL * n)):
        if not _abs_ok(got[k], want[k], atol):
            bad.append(k)
    ge, we = got["extra"], want["extra"]
    if not _abs_ok(ge["tardiness_integral"], we["tardiness_integral"], MINUTES_ATOL, TARD_RTOL):
        bad.append("tardiness_integral")
    if not _abs_ok(ge["makespan_min"], we["makespan_min"], MINUTES_ATOL):
        bad.append("makespan_min")
    gh, wh = got["util_histogram"], want["util_histogram"]
    if any(not _abs_ok(gh.get(k, 0.0), wh.get(k, 0.0), MINUTES_ATOL) for k in set(gh) | set(wh)):
        bad.append("util_histogram")
    if got["config_trace"] != [] or want["config_trace"] != []:
        bad.append("config_trace")
    return bad


def oracle_off(batched: Dict[str, Any], oracle: Dict[str, Any]) -> List[str]:
    """The fields of a batched result outside BATCHED_SIM.md §4 of the
    oracle's; ``num_jobs`` and ``repartitions`` exactly."""
    bad = [k for k in ("num_jobs", "repartitions") if batched[k] != oracle[k]]
    if abs(batched["energy_wh"] - oracle["energy_wh"]) > ENERGY_RTOL * abs(oracle["energy_wh"]):
        bad.append("energy_wh")
    d_tard = abs(batched["avg_tardiness"] - oracle["avg_tardiness"])
    if d_tard > TARDINESS_ATOL_MIN and d_tard > TARDINESS_RTOL * max(oracle["avg_tardiness"],
                                                                     TARDINESS_FLOOR):
        bad.append("avg_tardiness")
    if abs(batched["busy_slot_minutes"] - oracle["busy_slot_minutes"]) > max(
            BUSY_RTOL * abs(oracle["busy_slot_minutes"]), 1.0):
        bad.append("busy_slot_minutes")
    if abs(batched["preemptions"] - oracle["preemptions"]) > PREEMPTIONS_RTOL * max(
            oracle["preemptions"], PREEMPTIONS_FLOOR):
        bad.append("preemptions")
    return bad


def oracle_cell(cell: Dict[str, Any]) -> Dict[str, Any]:
    """The same cell on the oracle backend (no ``backend`` keys)."""
    return {k: v for k, v in cell.items() if k not in ("backend", "backend_kwargs")}


def _mean(results: Sequence[Dict[str, Any]], key: str) -> float:
    return sum(r[key] for r in results) / len(results)


def oracle_report(cells: Sequence[Dict], got: Sequence[Dict], oracle: Sequence[Dict],
                  reference: Sequence[Dict]) -> Dict[str, Any]:
    """The batched route's results (``got``) against the oracle's on the same
    cells, at the golden file's load: ``num_jobs`` and ``repartitions`` exact
    in every rollout; each group's means of energy, tardiness, busy minutes
    and preemptions within §4; and a rollout outside §4 only where the
    reference's own batched result (``reference``, the golden file's) is
    outside it too — at load 1.0 a few of the reference's 192 rollouts are
    (BATCHED_SIM.md calibrated §4 per rollout at load 0.2)."""
    exact_off = [i for i, (g, o) in enumerate(zip(got, oracle, strict=True))
                 if g["num_jobs"] != o["num_jobs"] or g["repartitions"] != o["repartitions"]]
    groups: Dict[str, List[int]] = {}
    for i, c in enumerate(cells):
        groups.setdefault(c["group"], []).append(i)
    keys = ("energy_wh", "avg_tardiness", "busy_slot_minutes", "preemptions")
    means = {}
    for name, idx in groups.items():
        mg = {k: _mean([got[i] for i in idx], k) for k in keys}
        mo = {k: _mean([oracle[i] for i in idx], k) for k in keys}
        pad = {"num_jobs": 0, "repartitions": 0}
        means[name] = {"off": oracle_off({**mg, **pad}, {**mo, **pad}), "batched": mg, "oracle": mo}
    label = [f"{c['group']}/{c['seed']}" for c in cells]
    outside = {label[i]: oracle_off(got[i], oracle[i]) for i in range(len(cells))
               if oracle_off(got[i], oracle[i])}
    ref_outside = {label[i]: oracle_off(reference[i], oracle[i]) for i in range(len(cells))
                   if oracle_off(reference[i], oracle[i])}
    ok = (not exact_off and not any(m["off"] for m in means.values())
          and set(outside) <= set(ref_outside))
    return {"ok": ok, "exact_off": [label[i] for i in exact_off], "group_means": means,
            "rollouts_outside": outside, "reference_rollouts_outside": ref_outside}
