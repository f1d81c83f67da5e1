"""R1 — determinism rules (DT001-DT003).

Applies to modules feeding ``cell_hash`` / ``SimResult`` / WAL records
(:data:`repro_torch.lint.paths.R1_PATHS`).  Everything a gated number depends on
must be a pure function of (seed, inputs, SIM_VERSION):

* ``DT001`` — global-state RNG: ``np.random.<draw>()`` module calls,
  stdlib ``random.<draw>()``, and torch's default generator — seeding it
  (``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed[_all]``)
  or drawing from it (``torch.rand*``/``randn*``/``randint*``/``randperm``/
  ``bernoulli``/``multinomial``/``normal``/``poisson`` and the in-place
  ``.uniform_``/``.normal_``/``.bernoulli_``/``.random_``/``.exponential_``/
  ``.geometric_``/``.log_normal_``/``.cauchy_`` called without
  ``generator=``).  Seeded constructors (``np.random.default_rng``,
  ``np.random.SeedSequence``, ``random.Random(seed)``,
  ``torch.Generator(...).manual_seed(seed)``) are fine — the rule targets
  the *process-global* streams whose state depends on import order and
  call history.
* ``DT002`` — wall-clock reads: any reference (not just call — passing
  ``time.monotonic`` as a ``time_source`` default counts) to
  ``time.time/monotonic/perf_counter[_ns]``, ``datetime.datetime.now`` and
  friends.  ``service/clock.py`` is legitimately wall-clocked and carries a
  file waiver.
* ``DT003`` — iteration over an unordered set.  Set iteration order is
  salted per process in no way the cache or the WAL can see; wrap in
  ``sorted(...)`` or iterate the ordered source instead.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.lint.base import Violation

__all__ = ["check_determinism"]

#: np.random attributes that construct *seeded* streams (allowed)
_NP_RANDOM_OK = {
    "default_rng",
    "Generator",
    "SeedSequence",
    "BitGenerator",
    "PCG64",
    "PCG64DXSM",
    "Philox",
    "SFC64",
    "MT19937",
}

#: stdlib random names that are allowed (seeded-instance construction)
_RANDOM_OK = {"Random", "getstate", "setstate"}

#: torch calls that seed the process-global generators
_TORCH_SEEDING = {
    "torch.manual_seed",
    "torch.seed",
    "torch.random.manual_seed",
    "torch.random.seed",
    "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
    "torch.cuda.seed",
    "torch.cuda.seed_all",
}

#: torch draws that use the default generator unless given ``generator=``
#: (``torch.rand_like`` & co. match by prefix)
_TORCH_DRAW_PREFIXES = ("torch.rand", "torch.randn", "torch.randint")
_TORCH_DRAWS = {
    "torch.randperm",
    "torch.bernoulli",
    "torch.multinomial",
    "torch.normal",
    "torch.poisson",
}

#: in-place tensor samplers (any receiver) that take ``generator=``
_INPLACE_DRAWS = {
    "uniform_",
    "normal_",
    "bernoulli_",
    "random_",
    "exponential_",
    "geometric_",
    "log_normal_",
    "cauchy_",
}

#: fully-resolved dotted names that read the wall clock
_WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.localtime",
    "time.gmtime",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}


class _Imports:
    """Alias -> dotted-module map from a file's import statements."""

    def __init__(self) -> None:
        self.names: Dict[str, str] = {}

    def feed(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                self.names[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of an Attribute/Name chain, import-resolved, or None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.names.get(node.id)
        if head is None:
            return None
        parts.append(head)
        return ".".join(reversed(parts))


def _passes_generator(call: ast.Call) -> bool:
    """``generator=`` given, or possibly given through a ``**kwargs`` splat."""
    return any(kw.arg in ("generator", None) for kw in call.keywords)


def _torch_global_draw(dotted: Optional[str]) -> bool:
    if dotted is None or not dotted.startswith("torch."):
        return False
    return dotted in _TORCH_DRAWS or (
        dotted.count(".") == 1 and dotted.startswith(_TORCH_DRAW_PREFIXES)
    )


def _is_setlike(node: ast.expr, set_names: Dict[str, ast.expr]) -> bool:
    """Conservatively: does this expression evaluate to a set?"""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in {"set", "frozenset"}:
            return True
        if isinstance(f, ast.Attribute) and f.attr in {
            "intersection",
            "union",
            "difference",
            "symmetric_difference",
        }:
            # .union/.difference exist on sets only (frozenset included);
            # str/list have no such methods, so this is unambiguous
            return True
    if isinstance(node, ast.Name) and node.id in set_names:
        return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str) -> None:
        self.path = path
        self.imports = _Imports()
        self.violations: List[Violation] = []
        # per-scope map of names assigned set-like values (module scope at
        # index 0; a function pushes a fresh scope)
        self._set_scopes: List[Dict[str, ast.expr]] = [{}]

    # -- imports ------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        self.imports.feed(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self.imports.feed(node)

    # -- scopes -------------------------------------------------------
    def visit_FunctionDef(self, node) -> None:
        self._set_scopes.append({})
        self.generic_visit(node)
        self._set_scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        scope = self._set_scopes[-1]
        for t in node.targets:
            if isinstance(t, ast.Name):
                if _is_setlike(node.value, scope):
                    scope[t.id] = node.value
                else:
                    scope.pop(t.id, None)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        # x |= {...} keeps set-ness; anything else clears our knowledge
        if isinstance(node.target, ast.Name) and not _is_setlike(
            node.value, self._set_scopes[-1]
        ):
            self._set_scopes[-1].pop(node.target.id, None)
        self.generic_visit(node)

    # -- DT001 --------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        dotted = self.imports.resolve(node.func)
        if dotted:
            parts = dotted.split(".")
            if parts[0] == "numpy" and len(parts) >= 3 and parts[1] == "random":
                if parts[2] not in _NP_RANDOM_OK:
                    self._flag(
                        "DT001", node,
                        f"np.random.{parts[2]}() draws from the process-global "
                        f"stream; use np.random.default_rng(seed)",
                    )
            elif parts[0] == "random" and len(parts) == 2:
                if parts[1] not in _RANDOM_OK:
                    self._flag(
                        "DT001", node,
                        f"random.{parts[1]}() uses the global stdlib stream; "
                        f"use a seeded random.Random(seed) or np.random.default_rng",
                    )
            elif dotted in _TORCH_SEEDING:
                self._flag(
                    "DT001", node,
                    f"{dotted}() seeds torch's process-global generator; pass "
                    f"a torch.Generator(device).manual_seed(seed) instead",
                )
            elif _torch_global_draw(dotted) and not _passes_generator(node):
                self._flag(
                    "DT001", node,
                    f"{dotted}() without generator= draws from torch's "
                    f"process-global stream; pass a seeded torch.Generator",
                )
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _INPLACE_DRAWS
            and not _passes_generator(node)
        ):
            self._flag(
                "DT001", node,
                f".{f.attr}() without generator= draws from torch's "
                f"process-global stream; pass a seeded torch.Generator",
            )
        self.generic_visit(node)

    # -- DT002 --------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        dotted = self.imports.resolve(node)
        if dotted in _WALL_CLOCK:
            self._flag(
                "DT002", node,
                f"{dotted} reads the wall clock; sim paths must derive time "
                f"from the event stream / seeded inputs",
            )
            return  # don't re-flag inner chain links
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            dotted = self.imports.resolve(node)
            if dotted in _WALL_CLOCK:
                self._flag("DT002", node, f"{dotted} reads the wall clock")

    # -- DT003 --------------------------------------------------------
    def _check_iter(self, iter_node: ast.expr) -> None:
        scope = self._set_scopes[-1]
        if _is_setlike(iter_node, scope):
            self._flag(
                "DT003", iter_node,
                "iteration over an unordered set — order varies per process; "
                "use sorted(...) or iterate the ordered source",
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    # a SetComp over a set is fine: the result is unordered anyway, and the
    # body runs per-element with no order-dependent accumulation we can see
    # — but flag it to be safe is noisy; skip SetComp iterables.

    # -- plumbing -----------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.violations.append(
            Violation(rule, self.path, node.lineno, node.col_offset, msg)
        )


def check_determinism(path: str, tree: ast.AST) -> List[Violation]:
    v = _Visitor(path)
    v.visit(tree)
    return v.violations
