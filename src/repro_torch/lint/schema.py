"""R4 — snapshot schema drift (SD001).

Pickled snapshot dataclasses (:data:`repro_torch.lint.paths.SNAPSHOT_REGISTRY`)
must carry two class attributes::

    SCHEMA_VERSION = 1                 # bump when the field set changes
    _schema_digest = "7f3a9c21"        # sha256(field names)[:8], lint-pinned

The digest is recomputed from the AST field list on every run, so adding,
removing, or renaming a field fails SD001 with the expected digest in the
message — forcing the edit to *also* touch the digest line, which the
``--diff`` gate (SD002, :mod:`repro_torch.lint.version_gate`) then requires to
come with a ``SCHEMA_VERSION`` bump.  Class attributes are not pickled, so
carrying them is free; the version rides along for readers that want to
refuse foreign blobs.
"""

from __future__ import annotations

import ast
import hashlib
from typing import List, Optional, Tuple

from repro_torch.lint.base import Violation

__all__ = ["extract_schema", "field_digest", "check_schema"]


def field_digest(fields: Tuple[str, ...]) -> str:
    return hashlib.sha256(",".join(fields).encode()).hexdigest()[:8]


def _is_classvar(ann: ast.expr) -> bool:
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    return (isinstance(ann, ast.Name) and ann.id == "ClassVar") or (
        isinstance(ann, ast.Attribute) and ann.attr == "ClassVar"
    )


def extract_schema(tree: ast.AST, classname: str):
    """(fields, digest_attr, version_attr, lineno) for a class, or None.

    ``fields`` are the annotated (dataclass) fields in declaration order;
    plain assignments like ``SCHEMA_VERSION = 1`` are class attributes.
    """
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == classname):
            continue
        fields: List[str] = []
        digest: Optional[str] = None
        version = None
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                if not _is_classvar(stmt.annotation):
                    fields.append(stmt.target.id)
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t = stmt.targets[0]
                if isinstance(t, ast.Name) and isinstance(stmt.value, ast.Constant):
                    if t.id == "_schema_digest":
                        digest = stmt.value.value
                    elif t.id == "SCHEMA_VERSION":
                        version = stmt.value.value
        return tuple(fields), digest, version, node.lineno
    return None


def check_schema(path: str, tree: ast.AST, classname: str) -> List[Violation]:
    got = extract_schema(tree, classname)
    if got is None:
        return [
            Violation(
                "SD001", path, 1, 0,
                f"registered snapshot class {classname!r} not found — update "
                f"repro_torch.lint.paths.SNAPSHOT_REGISTRY if it moved",
            )
        ]
    fields, digest, version, lineno = got
    expected = field_digest(fields)
    out: List[Violation] = []
    if version is None:
        out.append(
            Violation(
                "SD001", path, lineno, 0,
                f"{classname} is pickled but carries no SCHEMA_VERSION class "
                f"attribute; add `SCHEMA_VERSION = 1`",
            )
        )
    if digest is None:
        out.append(
            Violation(
                "SD001", path, lineno, 0,
                f"{classname} has no _schema_digest; add "
                f'`_schema_digest = "{expected}"` (sha256 of its field names)',
            )
        )
    elif digest != expected:
        out.append(
            Violation(
                "SD001", path, lineno, 0,
                f"{classname} field set changed: _schema_digest is "
                f"{digest!r} but the fields hash to {expected!r} — update the "
                f"digest AND bump SCHEMA_VERSION",
            )
        )
    return out
