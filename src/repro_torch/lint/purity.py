"""R2 — trace purity rules (JP001-JP004) over a lightweight call graph.

Scope: the modules whose code may run under a torch trace, a CUDA-graph
capture or a checkpoint recompute (:data:`repro_torch.lint.paths.R2_PATHS`).
Under each of them the same faults bite as under a JAX trace: a Python side
effect runs once at trace/capture time (or once more on a recompute) and
never on a replay, a branch on a tensor is frozen or forces a host sync, and
a host sync fails a capture.  The pass first resolves which functions
*reach* such a transform:

* **roots** — functions decorated with / passed to ``torch.compile``,
  ``torch.func.grad``/``grad_and_value``/``jacrev``/``jacfwd`` (jit-like),
  ``torch.vmap``/``torch.func.vmap``, ``torch.utils.checkpoint.checkpoint``,
  ``torch.cuda.make_graphed_callables``, ``torch.cond`` (bodies), and every
  call made directly inside a ``with torch.cuda.graph(...)`` block —
  including lambdas, ``partial(...)`` wrappers, and the factory idiom
  (``step = make_step_fn(...)`` → the inner def that ``make_step_fn``
  returns is traced when ``step`` is passed to a transform);
* **transitive** — anything a traced function calls by name (resolved
  through enclosing scopes, module globals, and imports within the R2
  module set).

Inside traced functions it flags Python side effects (JP001),
tensor-dependent ``if``/``while`` (JP002), host syncs —
``float()/int()/bool()`` and ``.item()/.tolist()/.cpu()/.numpy()`` of a
traced value (JP003) — and ``np.*`` calls on traced arguments (JP004).

Tracedness of a *parameter* is a heuristic (static analysis cannot see
every call site), tuned to this repo:

* bodies handed to ``vmap``/``checkpoint``/``cond``/
  ``make_graphed_callables`` have **all** params traced, and attribute
  access on a param (``state.remaining``) counts as traced — carries are
  NamedTuples of tensors;
* jit-like roots and graph-captured calls have all params traced but not
  their attributes (torch's transforms take no static-argument list; a
  parameter is static by its annotation, below);
* transitively-called helpers treat params as traced but ignore pure
  attribute access (``cfg.use_bias`` — config objects are closure-static
  in this codebase) and metadata queries (``x.shape``/``.ndim``/``.dtype``/
  ``.device``, ``x.size(0)``/``.dim()``/``.numel()``/``.data_ptr()``: an
  address is fixed under a capture, and none of them reads the values);
* a parameter annotated ``str``/``bool``/``int``/``float``, a
  ``Literal``, a config/spec type, ``torch.device`` or ``torch.dtype`` is
  static; one annotated ``torch.Tensor`` is traced whatever else its
  annotation says.

``is None`` / ``isinstance`` / ``hasattr`` tests and host queries
(``torch.is_*``, ``torch.cuda.*``, ``torch.distributed.*`` …) are never
flagged.  False positives that survive the heuristics get an inline
``# lint: waive[JP00x] reason``.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.lint.base import Violation
from repro_torch.lint.determinism import _Imports

__all__ = ["check_purity"]

#: transforms whose first function argument is traced like a jit root
_JIT_LIKE = {
    "torch.compile",
    "torch.func.grad",
    "torch.func.grad_and_value",
    "torch.func.jacrev",
    "torch.func.jacfwd",
}

#: dotted transform -> indices of function-valued positional args whose
#: params are all traced (a tuple/list there is a tuple of functions)
_BODY_ARGS = {
    "torch.vmap": (0,),
    "torch.func.vmap": (0,),
    "torch.utils.checkpoint.checkpoint": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    "torch.cond": (1, 2),
}

#: context managers whose block is captured: each call made directly in
#: it is a root
_CAPTURE_BLOCKS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

#: tensor attributes and methods that are static under a trace or capture
_SHAPE_ATTRS = {"shape", "ndim", "size", "dtype", "device", "is_cuda", "layout", "requires_grad"}
_SHAPE_METHODS = {"size", "dim", "numel", "stride", "is_contiguous", "element_size", "get_device",
                  "is_floating_point", "is_complex", "data_ptr"}
_STATIC_TESTS = {"isinstance", "hasattr", "callable", "len", "issubclass"}

#: methods that copy a tensor to the host (a sync; fails a capture)
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: torch namespaces whose calls answer host questions, not tensor ones
_HOST_QUERY_MODULES = ("torch.cuda.", "torch.distributed.", "torch.backends.", "torch.jit.",
                       "torch.compiler.", "torch.utils.", "torch.version.")
_HOST_QUERY_PREFIXES = ("is_", "get_", "are_", "can_")
_HOST_QUERY_NAMES = {"finfo", "iinfo", "device", "dtype", "Size", "numel", "promote_types",
                     "result_type"}


@dataclasses.dataclass
class _Func:
    qualname: str
    node: ast.AST  # FunctionDef | Lambda
    params: Tuple[str, ...]
    #: params whose annotation marks them static (str/bool/int/float
    #: hyperparams, config objects, torch.device/dtype) — see
    #: :func:`_annotation_static`
    annotated_static: Tuple[str, ...] = ()
    #: trace kind, set during root/propagation: None | "body" | "jit" | "called"
    kind: Optional[str] = None
    #: names of inner defs this function returns (factory idiom)
    returns: Tuple[str, ...] = ()


#: annotations that mark a parameter as a static hyperparameter rather
#: than a traced tensor: Python scalars/strings, config-object types, and
#: torch's device and dtype.  (A traced argument in this codebase is
#: annotated torch.Tensor/Any or not at all.)
_STATIC_ANN = re.compile(
    r"^(typing\.)?(Optional\[)?(str|bool|int|float)\]?$"
    r"|^(typing\.)?Literal\["
    r"|Config\b|Spec\b"
    r"|\btorch\.(device|dtype)\b"
)

#: an annotation naming a tensor is traced, whatever else it names
_TRACED_ANN = re.compile(r"\bTensor\b")


def _annotation_static(ann: Optional[ast.expr]) -> bool:
    if ann is None:
        return False
    try:
        text = ast.unparse(ann).strip("\"'")
    except Exception:
        return False
    if _TRACED_ANN.search(text):
        return False
    return bool(_STATIC_ANN.search(text))


def _annotated_static_params(args: ast.arguments) -> Tuple[str, ...]:
    out = []
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if _annotation_static(a.annotation):
            out.append(a.arg)
    return tuple(out)


class _FileIndex(ast.NodeVisitor):
    """One file's functions, scope tables, and local aliases."""

    def __init__(self, path: str, module: str, tree: ast.AST) -> None:
        self.path = path
        self.module = module
        self.tree = tree
        self.imports = _Imports()
        self.funcs: Dict[str, _Func] = {}
        #: scope qualname ("" = module) -> {local name: func qualname}
        self.scopes: Dict[str, Dict[str, str]] = {"": {}}
        #: scope -> {var name: qualname of the factory whose result it holds}
        self.aliases: Dict[str, Dict[str, str]] = {"": {}}
        self._stack: List[str] = [""]
        self.visit(tree)

    # -- scope helpers -------------------------------------------------
    @property
    def _scope(self) -> str:
        return self._stack[-1]

    def _qual(self, name: str) -> str:
        return f"{self._scope}.{name}".lstrip(".")

    # -- collection ----------------------------------------------------
    def visit_Import(self, node):  # noqa: D102 - trivial
        self.imports.feed(node)

    def visit_ImportFrom(self, node):  # noqa: D102 - trivial
        self.imports.feed(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._push(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _push(self, name: str) -> None:
        q = self._qual(name)
        self._stack.append(q)
        self.scopes.setdefault(q, {})
        self.aliases.setdefault(q, {})

    def visit_FunctionDef(self, node) -> None:
        q = self._qual(node.name)
        params = _param_names(node.args)
        self.funcs[q] = _Func(q, node, params, _annotated_static_params(node.args))
        self.scopes[self._scope][node.name] = q
        self._push(node.name)
        self.generic_visit(node)
        # record `return inner_def` for the factory idiom
        rets = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Name):
                target = self.lookup(sub.value.id, q)
                if target:
                    rets.append(target)
        self.funcs[q].returns = tuple(rets)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        # `step = make_step_fn(...)` — remember which factory built `step`
        if (
            len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Name)
        ):
            factory = self.lookup(node.value.func.id, self._scope)
            if factory:
                self.aliases[self._scope][node.targets[0].id] = factory
        self.generic_visit(node)

    # -- resolution ----------------------------------------------------
    def lookup(self, name: str, scope: str) -> Optional[str]:
        """Resolve a bare name to a function qualname via the scope chain."""
        while True:
            hit = self.scopes.get(scope, {}).get(name)
            if hit:
                return hit
            if not scope:
                return None
            scope = scope.rpartition(".")[0]

    def lookup_alias(self, name: str, scope: str) -> Optional[str]:
        while True:
            hit = self.aliases.get(scope, {}).get(name)
            if hit:
                return hit
            if not scope:
                return None
            scope = scope.rpartition(".")[0]


def _param_names(args: ast.arguments) -> Tuple[str, ...]:
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return tuple(names)


class _Analyzer:
    """Whole-module-set analysis: roots, propagation, then body checks."""

    def __init__(self, files: Dict[str, Tuple[str, ast.AST]]) -> None:
        # files: rel_path -> (module dotted name, tree)
        self.index: Dict[str, _FileIndex] = {}
        self.by_module: Dict[str, _FileIndex] = {}
        for path, (module, tree) in files.items():
            idx = _FileIndex(path, module, tree)
            self.index[path] = idx
            self.by_module[module] = idx
        self._lambda_seq = 0

    # -- phase 1: roots ------------------------------------------------
    def find_roots(self) -> None:
        for idx in self.index.values():
            for scope, node in _walk_scoped(idx):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{scope}.{node.name}".lstrip(".")
                    for dec in node.decorator_list:
                        self._maybe_decorator_root(idx, q, dec)
                elif isinstance(node, ast.Call):
                    self._maybe_transform_call(idx, scope, node)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    self._maybe_capture_block(idx, scope, node)

    def _maybe_decorator_root(self, idx: _FileIndex, q: str, dec: ast.expr) -> None:
        target = dec
        if isinstance(dec, ast.Call):
            dotted = idx.imports.resolve(dec.func)
            if dotted == "functools.partial" and dec.args:
                if idx.imports.resolve(dec.args[0]) in _JIT_LIKE:
                    self._mark(idx, q, "jit")
                return
            target = dec.func
        if idx.imports.resolve(target) in _JIT_LIKE:
            self._mark(idx, q, "jit")

    def _maybe_transform_call(self, idx: _FileIndex, scope: str, call: ast.Call) -> None:
        dotted = idx.imports.resolve(call.func)
        if dotted is None:
            return
        # partial(torch.compile, ...)(f) unwrapping is rare enough to skip;
        # the decorator form above covers the usual spelling.
        if dotted in _JIT_LIKE:
            if call.args:
                self._mark_expr(idx, scope, call.args[0], "jit")
        elif dotted in _BODY_ARGS:
            for i in _BODY_ARGS[dotted]:
                if i < len(call.args):
                    arg = call.args[i]
                    elts = arg.elts if isinstance(arg, (ast.List, ast.Tuple)) else [arg]
                    for e in elts:
                        self._mark_expr(idx, scope, e, "body")

    def _maybe_capture_block(self, idx: _FileIndex, scope: str, node) -> None:
        """``with torch.cuda.graph(g): ...`` — each call in the block is captured."""
        if not any(
            isinstance(item.context_expr, ast.Call)
            and idx.imports.resolve(item.context_expr.func) in _CAPTURE_BLOCKS
            for item in node.items
        ):
            return
        for sub in _walk_no_nested(node.body):
            if isinstance(sub, ast.Call):
                self._mark_expr(idx, scope, sub.func, "jit")

    def _mark_expr(self, idx, scope, expr, kind) -> None:
        if isinstance(expr, ast.Call):
            # partial(f, ...) or factory(...) used inline
            dotted = idx.imports.resolve(expr.func)
            if dotted == "functools.partial" and expr.args:
                self._mark_expr(idx, scope, expr.args[0], kind)
            elif isinstance(expr.func, ast.Name):
                factory = idx.lookup(expr.func.id, scope)
                if factory:
                    for ret in idx.funcs[factory].returns:
                        self._mark(idx, ret, kind)
            return
        if isinstance(expr, ast.Lambda):
            self._lambda_seq += 1
            q = f"<lambda#{self._lambda_seq}@{expr.lineno}>"
            idx.funcs[q] = _Func(q, expr, _param_names(expr.args))
            self._mark(idx, q, kind)
            return
        if isinstance(expr, ast.Name):
            q = idx.lookup(expr.id, scope)
            if q:
                self._mark(idx, q, kind)
                return
            factory = idx.lookup_alias(expr.id, scope)
            if factory:  # step = make_step_fn(...); vmap(step, ...)
                for ret in idx.funcs[factory].returns:
                    self._mark(idx, ret, kind)
                return
            imported = idx.imports.resolve(expr)
            if imported:
                self._mark_imported(imported, kind)
        elif isinstance(expr, ast.Attribute):
            imported = idx.imports.resolve(expr)
            if imported:
                self._mark_imported(imported, kind)

    def _mark_imported(self, dotted: str, kind) -> None:
        module, _, name = dotted.rpartition(".")
        idx = self.by_module.get(module)
        if idx and name in idx.scopes.get("", {}):
            self._mark(idx, idx.scopes[""][name], kind)

    def _mark(self, idx: _FileIndex, q: str, kind: str) -> None:
        fn = idx.funcs.get(q)
        if fn is None:
            return
        # "body" is the strictest kind; never downgrade it
        if fn.kind is None or kind == "body":
            fn.kind = kind

    # -- phase 2: propagation -----------------------------------------
    def propagate(self) -> None:
        work = [
            (idx, q)
            for idx in self.index.values()
            for q, fn in idx.funcs.items()
            if fn.kind is not None
        ]
        seen: Set[Tuple[str, str]] = {(idx.path, q) for idx, q in work}
        while work:
            idx, q = work.pop()
            fn = idx.funcs[q]
            if isinstance(fn.node, ast.Lambda):
                body: List[ast.AST] = [fn.node.body]
            else:
                body = fn.node.body
            for stmt in body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    tgt = self._resolve_callee(idx, q, sub.func)
                    if tgt is None:
                        continue
                    tidx, tq = tgt
                    if tidx.funcs[tq].kind is None and (tidx.path, tq) not in seen:
                        tidx.funcs[tq].kind = "called"
                        seen.add((tidx.path, tq))
                        work.append((tidx, tq))

    def _resolve_callee(self, idx, scope, func_expr):
        if isinstance(func_expr, ast.Name):
            q = idx.lookup(func_expr.id, scope)
            if q:
                return idx, q
            imported = idx.imports.resolve(func_expr)
            if imported:
                module, _, name = imported.rpartition(".")
                tidx = self.by_module.get(module)
                if tidx and name in tidx.scopes.get("", {}):
                    return tidx, tidx.scopes[""][name]
        elif isinstance(func_expr, ast.Attribute):
            imported = idx.imports.resolve(func_expr)
            if imported:
                module, _, name = imported.rpartition(".")
                tidx = self.by_module.get(module)
                if tidx and name in tidx.scopes.get("", {}):
                    return tidx, tidx.scopes[""][name]
        return None

    # -- phase 3: checks ----------------------------------------------
    def check(self) -> List[Violation]:
        out: List[Violation] = []
        for idx in self.index.values():
            for fn in idx.funcs.values():
                if fn.kind is not None:
                    out.extend(_check_traced(idx, fn))
        return out


def _walk_scoped(idx: _FileIndex):
    """Yield (enclosing scope qualname, node) over the whole file."""

    def rec(node: ast.AST, scope: str):
        for child in ast.iter_child_nodes(node):
            yield scope, child
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                yield from rec(child, f"{scope}.{child.name}".lstrip("."))
            else:
                yield from rec(child, scope)

    yield from rec(idx.tree, "")


def _refs_traced(expr: ast.expr, traced: Set[str], *, attr_is_traced: bool) -> bool:
    """Does this expression reference a traced parameter?

    Attribute chains rooted at a traced param count only when
    ``attr_is_traced`` (carries yes, config objects no); shape/dtype/device
    attributes and shape-query methods never count.
    """

    def rec(node: ast.AST, under_attr: bool) -> bool:
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return False
            return rec(node.value, True)
        if isinstance(node, ast.Name):
            if node.id not in traced:
                return False
            return attr_is_traced if under_attr else True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in _STATIC_TESTS:
                return False
            if isinstance(f, ast.Attribute) and f.attr in _SHAPE_METHODS:
                return False
            subs = list(node.args) + [k.value for k in node.keywords]
            if isinstance(f, ast.Attribute):
                subs.append(f.value)  # x.sum() on a traced x counts
            return any(rec(s, under_attr) for s in subs)
        return any(rec(c, under_attr) for c in ast.iter_child_nodes(node))

    return rec(expr, False)


def _is_static_test(test: ast.expr) -> bool:
    """`x is None` / isinstance-style tests are static under tracing."""
    if isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
    ):
        return True
    # `"key" in params_dict` — pytree *structure* is static under trace
    if (
        isinstance(test, ast.Compare)
        and all(isinstance(op, (ast.In, ast.NotIn)) for op in test.ops)
        and isinstance(test.left, ast.Constant)
    ):
        return True
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Name):
        if test.func.id in _STATIC_TESTS:
            return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_static_test(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(_is_static_test(v) for v in test.values)
    return False


def _calls_torch(expr: ast.expr, imports: _Imports) -> bool:
    """Does the expression call a torch op that yields a tensor?"""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            dotted = imports.resolve(sub.func)
            if not dotted or not dotted.startswith("torch."):
                continue
            name = dotted.rpartition(".")[2]
            if dotted.startswith(_HOST_QUERY_MODULES) or name in _HOST_QUERY_NAMES:
                continue
            if name.startswith(_HOST_QUERY_PREFIXES):
                continue
            return True
    return False


def _walk_no_nested(nodes):
    """Every node under ``nodes``, not entering nested defs or lambdas.

    A nested def or lambda is checked via its own traced entry (if it is
    traced at all) — never as part of the parent's body.
    """
    nested = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    stack = [n for n in nodes if not isinstance(n, nested)]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, nested):
                continue
            stack.append(c)


_WHERE = "a trace, a graph capture or a checkpoint recompute"


def _check_traced(idx: _FileIndex, fn: _Func) -> List[Violation]:
    out: List[Violation] = []
    traced = set(fn.params) - set(fn.annotated_static)
    attr_traced = fn.kind == "body"
    path = idx.path

    if isinstance(fn.node, ast.Lambda):
        stmts: List[ast.AST] = [fn.node.body]
    else:
        stmts = list(fn.node.body)

    for node in _walk_no_nested(stmts):
        # JP001 — Python side effects
        if isinstance(node, ast.Global):
            out.append(
                Violation(
                    "JP001", path, node.lineno, node.col_offset,
                    f"`global` write in {fn.qualname!r}, which reaches {_WHERE}: "
                    f"it runs when the code is traced or captured (and again on "
                    f"a recompute), never on a replay — keep state on the device "
                    f"or outside the traced code",
                )
            )
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in {"print", "open", "input"}:
                out.append(
                    Violation(
                        "JP001", path, node.lineno, node.col_offset,
                        f"{node.func.id}() in {fn.qualname!r}, which reaches "
                        f"{_WHERE}, runs at trace/capture time only (and again "
                        f"on a recompute); move it outside the traced code",
                    )
                )
            # JP003 — host casts of traced values
            elif node.func.id in {"float", "int", "bool"} and node.args:
                if _refs_traced(node.args[0], traced, attr_is_traced=attr_traced):
                    out.append(
                        Violation(
                            "JP003", path, node.lineno, node.col_offset,
                            f"{node.func.id}() of a traced tensor in "
                            f"{fn.qualname!r} syncs the host, breaks a trace and "
                            f"fails a graph capture; keep it on the device "
                            f"(.to(dtype), torch.where)",
                        )
                    )
        # JP003 — host syncs through tensor methods
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_SYNC_METHODS
            and _refs_traced(node.func.value, traced, attr_is_traced=attr_traced)
        ):
            out.append(
                Violation(
                    "JP003", path, node.lineno, node.col_offset,
                    f".{node.func.attr}() of a traced tensor in {fn.qualname!r} "
                    f"copies it to the host: it breaks a trace and fails a graph "
                    f"capture; keep it on the device",
                )
            )
        # JP004 — numpy on traced arguments
        if isinstance(node, ast.Call):
            dotted = idx.imports.resolve(node.func)
            if dotted and dotted.startswith("numpy."):
                argrefs = any(
                    _refs_traced(a, traced, attr_is_traced=attr_traced)
                    for a in list(node.args) + [k.value for k in node.keywords]
                )
                if argrefs:
                    out.append(
                        Violation(
                            "JP004", path, node.lineno, node.col_offset,
                            f"np.{dotted.split('.', 1)[1]}() on a traced "
                            f"argument in {fn.qualname!r} copies it to host "
                            f"numpy; use the torch op",
                        )
                    )
        # JP002 — tensor-dependent control flow
        if isinstance(node, (ast.If, ast.While)):
            test = node.test
            if _is_static_test(test):
                continue
            hit = _refs_traced(test, traced, attr_is_traced=attr_traced)
            torch_hit = _calls_torch(test, idx.imports)
            if hit or torch_hit:
                kw = "while" if isinstance(node, ast.While) else "if"
                why = (
                    "calls a torch op in its test" if torch_hit and not hit
                    else "branches on a traced parameter"
                )
                out.append(
                    Violation(
                        "JP002", path, node.lineno, node.col_offset,
                        f"Python `{kw}` in {fn.qualname!r}, which reaches "
                        f"{_WHERE}, {why}: a trace freezes the branch and a "
                        f"capture syncs the host; use torch.where/torch.cond",
                    )
                )
    return out


def check_purity(files: Dict[str, Tuple[str, ast.AST]]) -> List[Violation]:
    """Run JP001-JP004 over the R2 module set.

    ``files`` maps repo-relative path -> (dotted module name, parsed tree).
    """
    analyzer = _Analyzer(files)
    analyzer.find_roots()
    analyzer.propagate()
    return analyzer.check()
