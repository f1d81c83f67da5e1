"""CLI: ``python -m repro_torch.lint [paths...] [--diff BASE] [--json]``.

Exit code is the bitwise OR of failing categories — R1 determinism = 1,
R2 trace purity = 2, R3 version gates = 4, R4 schema drift = 8, waiver
hygiene = 16, internal (unparseable file) = 64 — so a CI log's exit status
names the broken contract.  Waived findings are listed but never fail.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.lint import RULES, category_of, lint_repo
from repro_torch.lint.base import CATEGORY_BITS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/dirs to sweep (default: src/repro_torch chip_smoke.py "
        "scripts/torch_sharded_cards.py)",
    )
    ap.add_argument(
        "--diff", metavar="BASE", default=None,
        help="also run the version-gate rules against this git base "
        "(e.g. origin/main)",
    )
    ap.add_argument("--root", default=None, help="repo root (default: auto-detect)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, (cat, summary) in sorted(RULES.items()):
            print(f"{rule}  [{cat}, exit bit {CATEGORY_BITS[cat]}]  {summary}")
        return 0

    report = lint_repo(
        root=args.root, targets=args.paths or None, diff_base=args.diff
    )

    if args.json:
        json.dump(report.to_dict(), sys.stdout, indent=2)
        print()
        return report.exit_code

    unwaived = [v for v in report.violations if not v.waived]
    waived = [v for v in report.violations if v.waived]
    for v in unwaived:
        print(f"{v.path}:{v.line}:{v.col}: {v.rule} [{category_of(v.rule)}] {v.message}")
    if waived:
        print(f"-- {len(waived)} waived finding(s):")
        for v in waived:
            print(f"   {v.path}:{v.line}: {v.rule} waived: {v.waive_reason}")
    for note in report.notes:
        print(f"note: {note}")
    status = "clean" if not unwaived else f"{len(unwaived)} violation(s)"
    print(
        f"repro_torch.lint: {report.files_checked} file(s), {status}, "
        f"{len(waived)} waived (exit {report.exit_code})"
    )
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
