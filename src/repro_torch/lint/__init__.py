"""``repro_torch.lint`` — the port's invariant analyzer.

The counterpart of the JAX package's analyzer, over the port's own tree
(docs/LINTING_TORCH.md has the full catalog).  Four machine-checked
contracts:

* **R1 determinism** (DT001-DT003) — no global-state RNG (numpy's module
  API, stdlib ``random``, torch's default generator), wall-clock reads, or
  unordered-set iteration in any module feeding ``cell_hash`` /
  ``SimResult`` / WAL records;
* **R2 trace purity** (JP001-JP004) — no Python side effects,
  tensor-dependent control flow, host syncs, or host-numpy calls inside
  functions reaching ``torch.compile`` / ``torch.func`` transforms /
  ``torch.vmap`` / ``checkpoint`` / a ``torch.cuda.graph`` capture;
* **R3 version gates** (VG001-VG002) — ``--diff <base>`` mode: physics
  edits require a ``SIM_VERSION`` bump, WAL codec edits a ``WAL_FORMAT``
  bump (comment/docstring-only edits exempt; in-diff waivers allowed);
* **R4 schema drift** (SD001-SD002) — pickled snapshot dataclasses carry
  ``SCHEMA_VERSION`` + a lint-pinned field-set digest.

Run ``python -m repro_torch.lint`` (optionally ``--diff origin/main``); the
inline escape hatch is ``# lint: waive[RULE] reason``.  Pure ``ast``,
``hashlib`` and ``git``: it imports neither torch nor JAX.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.lint.base import (
    CATEGORY_BITS,
    RULES,
    Violation,
    category_of,
    exit_code_for,
)
from repro_torch.lint.determinism import check_determinism
from repro_torch.lint.paths import (
    DEFAULT_TARGETS,
    R1_PATHS,
    R2_PATHS,
    SNAPSHOT_REGISTRY,
    find_repo_root,
    in_scope,
    iter_python_files,
)
from repro_torch.lint.purity import check_purity
from repro_torch.lint.schema import check_schema
from repro_torch.lint.version_gate import run_diff_gate
from repro_torch.lint.waivers import parse_waivers

__all__ = [
    "LintReport",
    "lint_repo",
    "Violation",
    "RULES",
    "CATEGORY_BITS",
    "exit_code_for",
]


@dataclasses.dataclass
class LintReport:
    violations: List[Violation]
    files_checked: int
    notes: List[str]  # non-fatal hygiene notes (unused waivers)

    @property
    def exit_code(self) -> int:
        return exit_code_for(self.violations)

    def to_dict(self) -> dict:
        unwaived = [v for v in self.violations if not v.waived]
        by_cat: Dict[str, int] = {}
        for v in unwaived:
            c = category_of(v.rule)
            by_cat[c] = by_cat.get(c, 0) + 1
        return {
            "version": 1,
            "files_checked": self.files_checked,
            "violations": [v.to_dict() for v in self.violations],
            "summary": {
                "total": len(self.violations),
                "unwaived": len(unwaived),
                "waived": len(self.violations) - len(unwaived),
                "by_category": by_cat,
            },
            "notes": self.notes,
            "exit_code": self.exit_code,
        }


def _module_name(rel_path: str) -> str:
    p = rel_path
    if p.startswith("src/"):
        p = p[len("src/"):]
    if p.endswith("/__init__.py"):
        p = p[: -len("/__init__.py")]
    elif p.endswith(".py"):
        p = p[: -len(".py")]
    return p.replace("/", ".")


def lint_repo(
    root: Optional[str] = None,
    targets: Optional[Sequence[str]] = None,
    diff_base: Optional[str] = None,
) -> LintReport:
    """Run every applicable rule; the library entry point the CLI wraps."""
    root = root or find_repo_root()
    rel_files = iter_python_files(root, targets or DEFAULT_TARGETS)

    violations: List[Violation] = []
    notes: List[str] = []
    waivers = {}
    purity_files: Dict[str, Tuple[str, ast.AST]] = {}
    registry = {}
    for path, cls in SNAPSHOT_REGISTRY:
        registry.setdefault(path, []).append(cls)

    for rel in rel_files:
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            violations.append(Violation("LE001", rel, 1, 0, f"unreadable: {e}"))
            continue
        fw = parse_waivers(rel, source)
        waivers[rel] = fw
        violations.extend(fw.errors)
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            violations.append(
                Violation("LE001", rel, e.lineno or 1, 0, f"syntax error: {e.msg}")
            )
            continue
        if in_scope(rel, R1_PATHS):
            violations.extend(check_determinism(rel, tree))
        if in_scope(rel, R2_PATHS):
            purity_files[rel] = (_module_name(rel), tree)
        for cls in registry.get(rel, ()):
            violations.extend(check_schema(rel, tree, cls))

    if purity_files:
        violations.extend(check_purity(purity_files))

    # apply inline waivers (diff-gate rules carry their own waiver logic)
    for v in violations:
        if v.waived or v.rule.startswith(("VG", "WV", "LE")):
            continue
        fw = waivers.get(v.path)
        if fw is not None:
            reason = fw.lookup(v.rule, v.line)
            if reason is not None:
                v.waived = True
                v.waive_reason = reason

    if diff_base is not None:
        violations.extend(run_diff_gate(root, diff_base))

    for rel, fw in sorted(waivers.items()):
        notes.extend(f"{rel}: {msg}" for msg in fw.unused())

    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return LintReport(violations, files_checked=len(rel_files), notes=notes)
