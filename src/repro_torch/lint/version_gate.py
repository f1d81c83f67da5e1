"""R3 — version-gate discipline (VG001, VG002, SD002), git-diff-aware.

``python -m repro_torch.lint --diff <base>`` compares the working tree against a
git base and fails when:

* **VG001** — a physics module (:data:`repro_torch.lint.paths.PHYSICS_PATHS`)
  changed *semantically* without a ``SIM_VERSION`` bump;
* **VG002** — a WAL codec module changed semantically without a
  ``WAL_FORMAT`` bump;
* **SD002** — a registered snapshot dataclass's field set changed without
  a ``SCHEMA_VERSION`` bump.

"Semantically" means the docstring-stripped AST differs: comment-only and
docstring-only edits never require a bump (CONTRIBUTING.md explicitly
wants pure refactors *proven* by the bit-identity suites instead, and a
comment edit is below even that bar).

The waiver for a legitimate no-bump change (e.g. a pure refactor covered
by the bit-identity gates) must appear on an **added line of the diff**::

    # lint: waive[VG001] pure refactor; engine bit-identity suite pins semantics

A waiver comment already in the file does not carry over to future diffs —
each PR earns its own exemption.

Limitation (documented, acceptable for CI where everything is committed):
files untracked by git are invisible to ``git diff`` and therefore to this
gate.
"""

from __future__ import annotations

import ast
import re
import subprocess
from typing import List, Optional, Tuple

from repro_torch.lint.base import Violation
from repro_torch.lint.paths import (
    PHYSICS_PATHS,
    SIM_VERSION_FILE,
    SNAPSHOT_REGISTRY,
    WAL_FORMAT_FILE,
    WAL_PATHS,
    in_scope,
)
from repro_torch.lint.schema import extract_schema

__all__ = ["run_diff_gate", "ast_fingerprint"]


def _git(root: str, *args: str) -> Optional[str]:
    try:
        proc = subprocess.run(
            ["git", *args], cwd=root, capture_output=True, text=True, timeout=60
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout if proc.returncode == 0 else None


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                node.body = body[1:] or [ast.Pass()]
    return tree


def ast_fingerprint(source: Optional[str]) -> Optional[str]:
    """Docstring-insensitive structural fingerprint; None = unparseable."""
    if source is None:
        return None
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    return ast.dump(_strip_docstrings(tree), annotate_fields=False, include_attributes=False)


def _base_source(root: str, base: str, path: str) -> Optional[str]:
    return _git(root, "show", f"{base}:{path}")


def _working_source(root: str, path: str) -> Optional[str]:
    import os

    abs_p = os.path.join(root, path)
    if not os.path.exists(abs_p):
        return None
    with open(abs_p, encoding="utf-8") as f:
        return f.read()


def _module_constant(source: Optional[str], name: str):
    """Module-level `NAME = <literal>` value, or None."""
    if source is None:
        return None
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    if isinstance(node.value, ast.Constant):
                        return node.value.value
    return None


_WAIVE_ADDED = re.compile(
    r"^\+.*#\s*lint:\s*waive\[(?P<rules>[A-Za-z0-9_,\s]+)\]\s*(?P<reason>\S.*)$"
)


def _added_waivers(root: str, base: str) -> dict:
    """rule -> reason for every waiver on an *added* diff line."""
    out: dict = {}
    diff = _git(root, "diff", "--unified=0", base, "--") or ""
    for line in diff.splitlines():
        m = _WAIVE_ADDED.match(line)
        if m:
            reason = m.group("reason").strip()
            for rule in (r.strip() for r in m.group("rules").split(",")):
                if rule and reason:
                    out[rule] = reason
    return out


def _gate(
    root: str,
    base: str,
    changed: List[str],
    scope_paths,
    version_file: str,
    version_name: str,
    rule: str,
    waivers: dict,
) -> List[Violation]:
    touched = [f for f in changed if in_scope(f, scope_paths)]
    significant = []
    for f in touched:
        old_fp = ast_fingerprint(_base_source(root, base, f))
        new_fp = ast_fingerprint(_working_source(root, f))
        if old_fp is None or new_fp is None or old_fp != new_fp:
            significant.append(f)
    if not significant:
        return []
    old_v = _module_constant(_base_source(root, base, version_file), version_name)
    new_v = _module_constant(_working_source(root, version_file), version_name)
    if old_v != new_v and new_v is not None:
        return []  # bumped — the gate is satisfied
    v = Violation(
        rule,
        version_file,
        1,
        0,
        f"{', '.join(significant)} changed semantically vs {base} but "
        f"{version_name} is still {new_v!r}; bump it (and regenerate the "
        f"baselines, CONTRIBUTING.md) or add an added-line waiver "
        f"`# lint: waive[{rule}] <why no bump is needed>`",
    )
    if rule in waivers:
        v.waived = True
        v.waive_reason = waivers[rule]
    return [v]


def _schema_gate(root: str, base: str, changed: List[str], waivers: dict) -> List[Violation]:
    out: List[Violation] = []
    for path, classname in SNAPSHOT_REGISTRY:
        if path not in changed:
            continue
        old_src = _base_source(root, base, path)
        new_src = _working_source(root, path)
        try:
            old = extract_schema(ast.parse(old_src), classname) if old_src else None
            new = extract_schema(ast.parse(new_src), classname) if new_src else None
        except SyntaxError:
            continue  # LE001 from the static pass covers unparseable files
        if old is None or new is None:
            continue  # class added/removed: SD001 static pass governs
        old_fields, _, old_version, _ = old
        new_fields, _, new_version, lineno = new
        if old_fields != new_fields and old_version == new_version:
            v = Violation(
                "SD002",
                path,
                lineno,
                0,
                f"{classname} field set changed vs {base} "
                f"({sorted(set(old_fields) ^ set(new_fields))}) but "
                f"SCHEMA_VERSION is still {new_version!r}; old pickles will "
                f"unpickle into the wrong shape — bump SCHEMA_VERSION",
            )
            if "SD002" in waivers:
                v.waived = True
                v.waive_reason = waivers["SD002"]
            out.append(v)
    return out


def run_diff_gate(root: str, base: str) -> List[Violation]:
    """VG001 + VG002 + SD002 for the working tree vs ``base``."""
    names = _git(root, "diff", "--name-only", base, "--")
    if names is None:
        return [
            Violation(
                "VG001", SIM_VERSION_FILE, 1, 0,
                f"git diff against {base!r} failed — is the base fetched? "
                f"(CI needs fetch-depth: 0 / an explicit fetch of the base)",
            )
        ]
    changed = [ln.strip() for ln in names.splitlines() if ln.strip()]
    waivers = _added_waivers(root, base)
    out = _gate(
        root, base, changed, PHYSICS_PATHS, SIM_VERSION_FILE, "SIM_VERSION",
        "VG001", waivers,
    )
    out += _gate(
        root, base, changed, WAL_PATHS, WAL_FORMAT_FILE, "WAL_FORMAT",
        "VG002", waivers,
    )
    out += _schema_gate(root, base, changed, waivers)
    return out
