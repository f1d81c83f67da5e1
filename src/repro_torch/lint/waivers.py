"""The ``# lint: waive[RULE] reason`` escape hatch.

Two scopes:

* ``# lint: waive[DT002] reason`` — waives the named rule(s) on the same
  line and the line immediately below (so both trailing comments and a
  comment-above style work; multi-line statements report at the statement
  head, which is the line under the comment).
* ``# lint: waive-file[DT002] reason`` — waives the rule(s) for the whole
  file (e.g. ``service/clock.py`` is *legitimately* wall-clocked).

A justification is mandatory: a waiver with no reason text is itself a
violation (``WV001``) — the whole point of the hatch is that the "why"
lives next to the exemption.  Several rules may share one waiver:
``waive[DT001,DT002]``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Set, Tuple

from repro_torch.lint.base import DIFF_SCOPED_RULES, RULES, Violation

__all__ = ["FileWaivers", "parse_waivers"]

_WAIVE_RE = re.compile(
    r"#\s*lint:\s*(?P<scope>waive-file|waive)\[(?P<rules>[A-Za-z0-9_,\s]+)\]\s*(?P<reason>.*)$"
)


class FileWaivers:
    """Parsed waivers for one file; answers "is (rule, line) waived?"."""

    def __init__(self) -> None:
        self.file_scope: Dict[str, str] = {}  # rule -> reason
        self.line_scope: Dict[Tuple[str, int], str] = {}  # (rule, line) -> reason
        self.errors: List[Violation] = []
        self._used: Set[Tuple[str, int]] = set()
        self._used_file: Set[str] = set()

    def lookup(self, rule: str, line: int):
        """Reason string when waived, else None; marks the waiver used."""
        if rule in self.file_scope:
            self._used_file.add(rule)
            return self.file_scope[rule]
        for probe in (line, line - 1):
            if (rule, probe) in self.line_scope:
                self._used.add((rule, probe))
                return self.line_scope[(rule, probe)]
        return None

    def unused(self) -> List[str]:
        """Human notes for waivers that suppressed nothing (hygiene aid)."""
        out = [
            f"unused file waiver for {rule}"
            for rule in sorted(set(self.file_scope) - self._used_file)
            if rule not in DIFF_SCOPED_RULES
        ]
        out.extend(
            f"unused waiver for {rule} at line {line}"
            for (rule, line) in sorted(set(self.line_scope) - self._used, key=lambda k: k[1])
            if rule not in DIFF_SCOPED_RULES
        )
        return out


def _comment_tokens(source: str):
    """(lineno, comment text) for every comment token; docstrings and
    string literals containing waiver *examples* are never parsed."""
    import io
    import tokenize

    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparseable files are reported as LE001 by the runner; no waivers
        return


def parse_waivers(path: str, source: str) -> FileWaivers:
    fw = FileWaivers()
    for lineno, text in _comment_tokens(source):
        m = _WAIVE_RE.search(text)
        if m is None:
            # catch near-miss syntax so typos don't silently waive nothing
            if re.search(r"#\s*lint:\s*waive", text):
                fw.errors.append(
                    Violation(
                        "WV001", path, lineno, 0,
                        "malformed waiver: expected '# lint: waive[RULE] reason' "
                        "or '# lint: waive-file[RULE] reason'",
                    )
                )
            continue
        rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        reason = m.group("reason").strip()
        bad = [r for r in rules if r not in RULES]
        if bad:
            fw.errors.append(
                Violation(
                    "WV001", path, lineno, 0,
                    f"waiver names unknown rule(s) {', '.join(bad)}; "
                    f"see docs/LINTING.md for the catalog",
                )
            )
        if not reason:
            fw.errors.append(
                Violation(
                    "WV001", path, lineno, 0,
                    f"waiver for {', '.join(rules)} has no justification — "
                    f"say why the exemption is legitimate",
                )
            )
            continue  # a reasonless waiver does not waive
        for rule in rules:
            if rule in RULES:
                if m.group("scope") == "waive-file":
                    fw.file_scope[rule] = reason
                else:
                    fw.line_scope[(rule, lineno)] = reason
    return fw
