"""Violation model, rule registry, and category/exit-code mapping.

``repro_torch.lint`` converts the port's implicit correctness contracts —
seeded-RNG-only physics, pure traced and captured code, version bumps on
physics edits, versioned snapshot schemas — into machine-checked rules.
Each rule has a stable id (``DT001``, ``JP002``, …) grouped into the four
categories of docs/LINTING_TORCH.md; the CLI exit code is the bitwise OR of
the failing categories, so CI logs show *which* contract broke without
parsing output.  Ids, categories and exit bits are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = [
    "Violation",
    "CATEGORY_BITS",
    "RULE_CATEGORY",
    "RULES",
    "DIFF_SCOPED_RULES",
    "category_of",
    "exit_code_for",
]


#: category -> exit-code bit.  R1 determinism, R2 trace purity, R3 version
#: gates, R4 schema drift, WV waiver hygiene, plus 64 for internal errors.
CATEGORY_BITS: Dict[str, int] = {
    "R1": 1,
    "R2": 2,
    "R3": 4,
    "R4": 8,
    "WV": 16,
    "internal": 64,
}

#: every rule id -> (category, one-line summary).  docs/LINTING_TORCH.md renders
#: this table; tests assert the two stay in sync.
RULES: Dict[str, tuple] = {
    "DT001": ("R1", "global-state RNG call (np.random.* module API, stdlib random, "
              "torch's default generator: torch.manual_seed, torch.rand* without generator=)"),
    "DT002": ("R1", "wall-clock read (time.time/monotonic/perf_counter, datetime.now)"),
    "DT003": ("R1", "iteration over an unordered set (use sorted(...))"),
    "JP001": ("R2", "Python side effect (print/open/global write) in code that reaches a trace, "
              "a graph capture or a checkpoint recompute"),
    "JP002": ("R2", "Python if/while on a traced tensor in code that reaches a trace, "
              "a graph capture or a checkpoint recompute (use torch.where/torch.cond)"),
    "JP003": ("R2", "host sync of a traced tensor: float()/int()/bool(), "
              ".item()/.tolist()/.cpu()/.numpy()"),
    "JP004": ("R2", "numpy call on a traced argument in code that reaches a trace, "
              "a graph capture or a checkpoint recompute"),
    "VG001": ("R3", "physics module changed without a SIM_VERSION bump or waiver"),
    "VG002": ("R3", "WAL module changed without a WAL_FORMAT bump or waiver"),
    "SD001": ("R4", "snapshot dataclass schema digest missing or stale"),
    "SD002": ("R4", "snapshot field set changed without a SCHEMA_VERSION bump"),
    "WV001": ("WV", "malformed waiver (missing rule id or justification)"),
    "LE001": ("internal", "file could not be parsed"),
}

RULE_CATEGORY: Dict[str, str] = {rule: cat for rule, (cat, _) in RULES.items()}

#: rules enforced only by ``--diff`` mode; their inline waivers are matched
#: against *added diff lines* rather than the static waiver table, so the
#: static pass must not report them as "unused".
DIFF_SCOPED_RULES = frozenset({"VG001", "VG002", "SD002"})


@dataclasses.dataclass
class Violation:
    """One finding.  ``waived`` findings are reported but never fail."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    waived: bool = False
    waive_reason: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "category": category_of(self.rule),
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "waived": self.waived,
        }
        if self.waive_reason is not None:
            d["waive_reason"] = self.waive_reason
        return d


def category_of(rule: str) -> str:
    return RULE_CATEGORY.get(rule, "internal")


def exit_code_for(violations: List[Violation]) -> int:
    """Bitwise OR of the categories with at least one unwaived violation."""
    code = 0
    for v in violations:
        if not v.waived:
            code |= CATEGORY_BITS[category_of(v.rule)]
    return code
