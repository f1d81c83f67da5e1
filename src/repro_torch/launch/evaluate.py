"""Score repartitioning policies on the event-driven simulator, with the greedy DQN on the card.

The port's evaluator: the counterpart of ``scripts/train_rl_baseline.py
--check`` (the RL-against-forecast race) and of the reference's Table III
grid, with a replay of checked-in sweep rows.  The sweep engine's own gate,
``python -m repro_torch.sweep <grid> --check-baseline <file>``, rebuilds a
grid's cells and diffs its artifact; ``--replay`` instead reruns the cells
stored in the files as they are, without rebuilding them::

    python -m repro_torch.launch.evaluate --race --params P.npz [--scale 0.1]
    python -m repro_torch.launch.evaluate --table3 [--params P.npz] [--scale 1.0]
    python -m repro_torch.launch.evaluate --replay benchmarks/baselines/smoke_sweep.jsonl [--rtol 1e-9]

* ``--race`` evaluates the greedy policy of ``P.npz`` on its 15-minute
  training cadence against the forecast controller on the six scenario
  families (EDF-SS, seeds from 90 000, ``max(int(40 * scale), 4)`` days a
  family) and prints rows in ``rl_batched.json``'s schema, then
  ``families_beaten`` and the params probe;
* ``--table3`` runs Table III's cells (``WorkloadSpec`` days, seeds from
  40 000, ``max(int(10 * scale), 2)`` a model): NoMIG, static config 3,
  DayNight, the queue heuristic and, with ``--params``, the registry's
  ``"dqn"`` (event cadence), and prints ET and the improvement over NoMIG.
  After ``python -m repro_torch.launch.train_rl --backend host --out P.npz``
  it is the paper's headline experiment
  (``examples/dynamic_repartitioning_day.py``);
* ``--replay`` runs every stored cell of checked-in sweep baselines and compares
  each result with the reference's rule (``rtol`` relative to the larger
  magnitude, at least 1; ``elapsed_s`` skipped), integers (``dispatch_counts``
  and the devices' tenant counts among them), ``config_trace`` and
  ``util_histogram`` exactly.  The checked-in files it takes:
  ``smoke_sweep``, ``scenario_matrix``, ``repartition_policies``,
  ``repartition_modes`` and the fleet rows of ``fleet_scaling``,
  ``dispatchers`` and ``serving_matrix`` (``benchmarks/baselines/*.jsonl``).

The Q network runs on ``--device`` (default: the CUDA card; the command
raises without one, ``--device cpu`` on request); everything else is float64
host code.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.metrics import SimResult, et_table
from repro_torch.core.rl.agent import greedy_policy
from repro_torch.core.rl.dqn import DQNLearner
from repro_torch.core.rl.train import evaluate_policy
from repro_torch.core.workload import WorkloadSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train_rl import DECISION_INTERVAL_MIN, dqn_config
from repro_torch.sweep.__main__ import _values_close as values_close
from repro_torch.sweep.cells import make_cell, run_cell
from repro_torch.sweep.grids import SCENARIO_ORDER, _table3_aggregate, _table3_models
from repro_torch.sweep.grids import _iters as iters

__all__ = [
    "SCENARIO_ORDER",
    "EVAL_SEED",
    "iters",
    "load_learner",
    "params_probe",
    "DecisionLog",
    "action_flips",
    "race",
    "table3_cells",
    "table3",
    "values_close",
    "replay",
    "compare_rows",
    "main",
]

#: first seed of the race's evaluation days
EVAL_SEED = 90_000


def load_learner(params_path: str, device: DeviceLike = None) -> DQNLearner:
    """The baseline's learner with ``params_path`` loaded, on ``device``."""
    learner = DQNLearner(dqn_config(), device=device)
    learner.load(params_path)
    return learner


def params_probe(learner, seed: int = 123, n: int = 16) -> Dict[str, Any]:
    """Greedy actions on ``rl_batched.json``'s fixed pseudo-random observations."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.0, 1.0, size=(n, learner.cfg.state_dim))
    return {
        "seed": seed,
        "actions": [int(learner.greedy_action(o.astype(np.float32))) for o in obs],
    }


class DecisionLog:
    """A learner's greedy decisions, recorded: observation, Q values, action.

    Stands in for the learner inside :func:`greedy_policy` (which reads only
    ``cfg`` and ``greedy_action``); each decision is the learner's own
    ``argmax(q(state))``.
    """

    def __init__(self, learner: DQNLearner) -> None:
        self.learner = learner
        self.cfg = learner.cfg
        self.records: List[Tuple[str, np.ndarray, np.ndarray, int]] = []
        self.label = ""

    def greedy_action(self, state: np.ndarray) -> int:
        q = self.learner.q(state)
        action = int(np.argmax(q))
        self.records.append((self.label, np.asarray(state, np.float32), q, action))
        return action


def action_flips(log: DecisionLog, other: DQNLearner) -> List[Dict[str, Any]]:
    """Decisions where ``other`` (e.g. the CPU) picks another action than the log.

    Each entry gives the family, the decision's index in the log, both
    actions and the gap between the log's top two Q values.
    """
    flips = []
    for i, (label, state, q, action) in enumerate(log.records):
        mine = other.greedy_action(state)
        if mine != action:
            top2 = np.sort(q)[-2:]
            flips.append({
                "family": label, "decision": i, "action": action, "other_action": mine,
                "q_gap": float(top2[1] - top2[0]),
            })
    return flips


def race(
    learner,
    scale: float = 0.1,
    families: Sequence[str] = SCENARIO_ORDER,
    device: DeviceLike = None,
) -> Tuple[List[Dict[str, Any]], Dict[str, Dict[str, List[SimResult]]]]:
    """The greedy DQN against the forecast controller on each family.

    Follows ``scripts/train_rl_baseline.py``'s ``evaluate``: EDF-SS, the
    same seeds on both sides, the DQN on its 15-minute cadence through an
    ad-hoc factory, the forecast controller from the registry fitted on the
    family.  ``learner`` is a :class:`DQNLearner` or a :class:`DecisionLog`
    (whose ``label`` is set to each family in turn).  Returns the rows in
    ``rl_batched.json``'s schema and the per-family results.
    """
    n = iters(40, scale, floor=4)
    rows, per_family = [], {}
    for sname in families:
        if isinstance(learner, DecisionLog):
            learner.label = sname
        common = dict(
            num_iterations=n, scheduler_name="EDF-SS", seed=EVAL_SEED, scenario=sname,
            device=device,
        )
        per = {
            "DQN": evaluate_policy(
                lambda: greedy_policy(learner, decision_interval_min=DECISION_INTERVAL_MIN),
                **common,
            ),
            "Forecast": evaluate_policy(("forecast", {"scenario": sname}), **common),
        }
        t, a = et_table(per)
        rows.append({
            "scenario": sname,
            "et_a": a,
            "ET_DQN": round(t["DQN"], 4),
            "ET_Forecast": round(t["Forecast"], 4),
            "dqn_beats_forecast": bool(t["DQN"] < t["Forecast"]),
            "repartitions_DQN": round(sum(r.repartitions for r in per["DQN"]) / n, 1),
            "energy_wh_DQN": round(sum(r.energy_wh for r in per["DQN"]) / n, 1),
            "iterations": n,
        })
        per_family[sname] = per
    return rows, per_family


def table3_cells(scale: float = 1.0, params_path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Table III's cells in the reference's order: model by model, seed by seed.

    The models are the grid's (:mod:`repro_torch.sweep.grids`): NoMIG,
    static config 3, DayNight, the queue heuristic and, with ``params_path``,
    the registry's ``"dqn"`` on those weights (event cadence, as the
    reference's Table III runs it).
    """
    models = _table3_models(include_dqn=params_path is not None)
    if params_path is not None:
        name, overrides = models[-1]
        models[-1] = (name, {**overrides, "policy_kwargs": {"params_path": params_path}})
    spec = WorkloadSpec()
    seeds = [40_000 + k for k in range(iters(10, scale, floor=2))]
    return [
        make_cell(
            experiment="table3_repartitioning", group=name, scheduler="EDF-SS",
            workload=spec, seed=s, **overrides,
        )
        for name, overrides in models
        for s in seeds
    ]


def table3(
    scale: float = 1.0, params_path: Optional[str] = None, device: DeviceLike = None
) -> List[Dict[str, Any]]:
    """Table III's rows (the grid's aggregate): per model, ET (shared ``a``),
    the improvement over NoMIG in percent, and the means of the headline
    metrics."""
    dev = resolve_device(device)
    cells = table3_cells(scale, params_path)
    return _table3_aggregate(cells, [run_cell(cell, device=dev) for cell in cells])


def _max_rel(a: Any, b: Any) -> float:
    """Largest ``|a - b| / max(|a|, |b|, 1)`` over the floats of two results."""
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        return abs(fa - fb) / max(abs(fa), abs(fb), 1.0)
    if isinstance(a, dict) and isinstance(b, dict):
        return max((_max_rel(a[k], b[k]) for k in a.keys() & b.keys()), default=0.0)
    if isinstance(a, list) and isinstance(b, list):
        return max((_max_rel(x, y) for x, y in zip(a, b, strict=False)), default=0.0)
    return 0.0


def _exact_part(result: Dict[str, Any]) -> Dict[str, Any]:
    """What must match exactly: the integers, the trace and the histogram."""
    return {
        **{k: v for k, v in result.items() if isinstance(v, (int, bool))},
        "config_trace": result["config_trace"],
        "util_histogram": result["util_histogram"],
    }


def replay(path: str, rtol: float = 1e-9, device: DeviceLike = None) -> Dict[str, Any]:
    """Run every cell of a checked-in sweep baseline and compare its result.

    Returns :func:`compare_rows`'s report of the file with the wall seconds.
    """
    dev = resolve_device(device)
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    t0 = time.perf_counter()
    results = [run_cell(rec["cell"], device=dev) for rec in rows]
    return {**compare_rows(os.path.basename(path), rows, results, rtol),
            "seconds": time.perf_counter() - t0}


def compare_rows(name: str, rows: Sequence[Dict[str, Any]], results: Sequence[Dict[str, Any]],
                 rtol: float = 1e-9) -> Dict[str, Any]:
    """Each stored row's result against the result its cell gave now.

    Returns the row count, how many rows hold (``rtol`` on the floats, the
    integers, ``config_trace`` and ``util_histogram`` exact; ``elapsed_s``
    skipped), the largest relative float difference and the cells of the
    rows that do not hold.
    """
    within, max_rel, off = 0, 0.0, []
    for rec, got in zip(rows, results, strict=True):
        got = {k: v for k, v in got.items() if k != "elapsed_s"}
        want = rec["result"]
        ok = values_close(got, want, rtol) and _exact_part(got) == _exact_part(want)
        within += ok
        max_rel = max(max_rel, _max_rel(got, want))
        if not ok:
            off.append({"group": rec["cell"]["group"], "seed": rec["cell"]["seed"]})
    return {"file": name, "rows": len(rows), "within_rtol": within, "rtol": rtol,
            "max_rel_diff": max_rel, "off": off}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--race", action="store_true",
                      help="the greedy DQN of --params against the forecast controller")
    mode.add_argument("--table3", action="store_true", help="Table III's repartitioning models")
    mode.add_argument("--replay", nargs="+", metavar="FILE.jsonl",
                      help="checked-in sweep baselines to rerun and compare")
    ap.add_argument("--params", default=None, help="DQN weights (npz, the reference's layout)")
    ap.add_argument("--scale", type=float, default=None,
                    help="days per group as in the reference grids (race 0.1, table3 1.0)")
    ap.add_argument("--rtol", type=float, default=1e-9, help="--replay's float tolerance")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.race:
        if args.params is None:
            ap.error("--race needs --params")
        learner = load_learner(args.params, device)
        rows, _ = race(learner, 0.1 if args.scale is None else args.scale, device=device)
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps({
            "families_beaten": [r["scenario"] for r in rows if r["dqn_beats_forecast"]],
            "params_probe": params_probe(learner), "device": str(device),
        }), flush=True)
        return 0
    if args.table3:
        rows = table3(1.0 if args.scale is None else args.scale, args.params, device)
        for row in rows:
            print(json.dumps(row), flush=True)
        return 0
    bad = 0
    for path in args.replay:
        out = replay(path, args.rtol, device)
        bad += out["rows"] - out["within_rtol"]
        print(json.dumps(out), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
