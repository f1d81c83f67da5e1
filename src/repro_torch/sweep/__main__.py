"""CLI for the port's sweep engine.

::

    python -m repro_torch.sweep --list
    python -m repro_torch.sweep fleet_scaling --workers 4
    python -m repro_torch.sweep --grid table2_schedulers --workers 4
    python -m repro_torch.sweep smoke --scale 0.1 --workers 2 \\
        --check-baseline benchmarks/baselines/smoke_sweep.jsonl
    python -m repro_torch.sweep smoke --scale 0.1 --device cpu

Grids are named positionally or via the repeatable ``--grid`` flag.
``--resume`` (default) serves previously computed cells from the on-disk
cache; ``--no-resume`` recomputes everything (results are still persisted).
Resuming refuses (exit 2) when the cache holds cells from a different
``SIM_VERSION`` — ``--purge-stale-cache`` drops them first.
``--check-baseline`` re-reads the freshly written JSONL artifact and compares
it cell-by-cell against a checked-in baseline with a float tolerance; a
mismatch exits non-zero (the CI regression gate).

The reference's CLI (``python -m repro.sweep``) with one addition:
``--device`` names where the registry's ``"dqn"`` runs its Q network and
batched cells run their simulator (default: the CUDA card; the command
raises without one, ``--device cpu`` on request).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List

from repro_torch.sweep.cache import DEFAULT_CACHE_DIR, StaleCacheError, SweepCache
from repro_torch.sweep.grids import GRIDS, run_grid


def _fmt(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def print_rows(name: str, rows: List[Dict[str, Any]]) -> None:
    if not rows:
        print(f"# {name}: no rows")
        return
    keys = list(rows[0].keys())
    print(f"### {name}")
    print(",".join(keys))
    for r in rows:
        print(",".join(_fmt(r.get(k)) for k in keys))
    print()


def _values_close(a: Any, b: Any, rtol: float) -> bool:
    """The baseline rule: floats within ``rtol`` of the larger magnitude (at
    least 1), dicts and lists element by element, the rest ``==``."""
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        return abs(fa - fb) <= rtol * max(abs(fa), abs(fb), 1.0)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _values_close(a[k], b[k], rtol) for k in a
        )
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _values_close(x, y, rtol) for x, y in zip(a, b, strict=True)
        )
    return a == b


def check_baseline(jsonl_path: str, baseline_path: str, rtol: float) -> int:
    """Compare a sweep JSONL artifact against a baseline; returns #mismatches."""
    with open(jsonl_path) as f:
        got = [json.loads(line) for line in f if line.strip()]
    with open(baseline_path) as f:
        want = [json.loads(line) for line in f if line.strip()]
    mismatches = 0
    by_hash = {rec["hash"]: rec for rec in got}
    for rec in want:
        mine = by_hash.get(rec["hash"])
        if mine is None:
            print(f"BASELINE MISS: no cell with hash {rec['hash'][:12]}…")
            mismatches += 1
            continue
        if not _values_close(mine["result"], rec["result"], rtol):
            print(
                f"BASELINE DIFF at hash {rec['hash'][:12]}…:\n"
                f"  want {json.dumps(rec['result'], sort_keys=True)[:300]}\n"
                f"  got  {json.dumps(mine['result'], sort_keys=True)[:300]}"
            )
            mismatches += 1
    if len(got) != len(want):
        print(f"BASELINE SIZE: baseline has {len(want)} cells, run has {len(got)}")
        mismatches += 1
    return mismatches


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep")
    ap.add_argument("grids", nargs="*", metavar="GRID",
                    help="grid name(s) to run (same namespace as --grid)")
    ap.add_argument("--grid", action="append", default=None,
                    help="grid name (repeatable), or 'all'; default table2_schedulers")
    ap.add_argument("--list", action="store_true", help="list available grids")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="iteration-count multiplier (1.0 = CI-sized)")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes; <=1 runs inline")
    ap.add_argument("--resume", dest="resume", action="store_true", default=True,
                    help="serve completed cells from the cache (default)")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="ignore cached cells; recompute everything")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the on-disk cache entirely")
    ap.add_argument("--cache-dir", default=None, help="cache directory override")
    ap.add_argument("--purge-stale-cache", action="store_true",
                    help="delete cached cells from other SIM_VERSIONs, then run")
    ap.add_argument("--artifacts-dir", default=None,
                    help="JSONL artifact directory (default artifacts/sweeps)")
    ap.add_argument("--check-baseline", default=None, metavar="JSONL",
                    help="diff the artifact against this baseline; exit 1 on drift")
    ap.add_argument("--rtol", type=float, default=1e-9,
                    help="relative float tolerance for --check-baseline")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.list:
        for name, grid in sorted(GRIDS.items()):
            print(f"{name:24s} {grid.doc}")
        return 0

    names = list(args.grids) + list(args.grid or [])
    explicit_grids = bool(names)
    if not names:
        names = ["table2_schedulers"]
    if "all" in names:
        names = [n for n in GRIDS if n != "smoke"]
    unknown = [n for n in names if n not in GRIDS]
    if unknown:
        ap.error(f"unknown grid(s) {unknown}; available: {', '.join(sorted(GRIDS))}")
    if args.check_baseline and not os.path.exists(args.check_baseline):
        ap.error(f"baseline file not found: {args.check_baseline}")
    if args.check_baseline and len(names) > 1:
        # one baseline file cannot describe several grids; diffing each grid
        # against it would guarantee spurious mismatches for all but one
        ap.error(
            "--check-baseline takes exactly one grid per invocation "
            f"(got {len(names)}: {', '.join(names)})"
        )

    cache: Any = True
    if args.no_cache:
        cache = False
    elif args.cache_dir:
        cache = args.cache_dir

    if args.purge_stale_cache and not args.no_cache:
        purge_dir = args.cache_dir or DEFAULT_CACHE_DIR
        removed = SweepCache(purge_dir).purge_stale()
        print(f"# purged {removed} stale cache entries from {purge_dir}",
              file=sys.stderr)
        if not explicit_grids:
            # bare `--purge-stale-cache` (the StaleCacheError remediation)
            # is purge-only — don't surprise the user with a default sweep
            return 0

    kwargs: Dict[str, Any] = {}
    if args.artifacts_dir is not None:
        kwargs["artifacts_dir"] = args.artifacts_dir

    failed = 0
    for name in names:
        t0 = time.time()  # lint: waive[DT002] progress-log timing only
        try:
            rows, outcome = run_grid(
                name,
                scale=args.scale,
                workers=args.workers,
                cache=cache,
                resume=args.resume,
                progress=lambda m: print(m, file=sys.stderr),
                device=args.device,
                **kwargs,
            )
        except StaleCacheError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 2
        print_rows(name, rows)
        print(
            f"# {name}: {outcome.total} cells "
            f"({outcome.cached_count} cached, {outcome.computed_count} computed) "
            f"in {time.time() - t0:.1f}s -> {outcome.jsonl_path}",  # lint: waive[DT002] progress log
            file=sys.stderr,
        )
        if args.check_baseline:
            n_bad = check_baseline(outcome.jsonl_path, args.check_baseline, args.rtol)
            if n_bad:
                print(f"# {name}: {n_bad} baseline mismatches", file=sys.stderr)
                failed += n_bad
            else:
                print(f"# {name}: matches baseline {args.check_baseline}",
                      file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
