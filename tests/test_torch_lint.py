"""repro_torch.lint — the port's invariant analyzer (docs/LINTING_TORCH.md).

Three parts:

* the port's own suite: every case of tests/test_lint.py against
  ``repro_torch.lint``, with JAX fixtures transcribed to torch, plus the
  torch roots of R2 (``torch.compile``, ``torch.func``, ``torch.vmap``,
  ``checkpoint``, ``make_graphed_callables``, ``torch.cond``, a
  ``torch.cuda.graph`` block), the host syncs ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``, and torch's default generator under DT001;
* parity with the JAX package's analyzer: the same R1, R3, R4 and WV
  fixtures under ``src/repro/`` and ``src/repro_torch/`` give the same
  ``(rule, line, col)`` lists, each JAX purity fixture and its line-for-line
  torch transcription the same ``(rule, line)`` list, and the digests,
  fingerprints and pinned snapshot digests agree;
* the sweep of the real tree: clean, and each repaired fault (a schema
  digest, a wall-clock waiver, an R2 waiver or annotation) taken out of a
  copy comes back with its rule and exit bit.

Fixtures live in tmp trees (tests/ is outside the default sweep because it
hosts deliberately bad code).  Nothing here touches a device.
"""

import ast
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.lint as ref_lint
from repro.lint.schema import extract_schema as ref_extract_schema
from repro.lint.schema import field_digest as ref_field_digest
from repro.lint.version_gate import ast_fingerprint as ref_ast_fingerprint
from repro_torch.lint import CATEGORY_BITS, RULES, LintReport, lint_repo
from repro_torch.lint.base import Violation, category_of, exit_code_for
from repro_torch.lint.paths import R2_PATHS, SNAPSHOT_REGISTRY
from repro_torch.lint.schema import extract_schema, field_digest
from repro_torch.lint.version_gate import ast_fingerprint
from repro_torch.lint.waivers import parse_waivers

REPO_ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------------
# helpers

def make_repo(tmp_path, files, pkg="repro_torch"):
    """A bare lint-rooted tree: pyproject marker + the given rel->source;
    ``{pkg}`` in a path names the package."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel, src in files.items():
        p = tmp_path / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tmp_path


def unwaived_rules(report: LintReport):
    return sorted(v.rule for v in report.violations if not v.waived)


def waived_rules(report: LintReport):
    return sorted(v.rule for v in report.violations if v.waived)


def git(root, *args):
    subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=root, check=True, capture_output=True,
    )


def commit_all(root, msg="c"):
    git(root, "add", "-A")
    git(root, "commit", "-q", "-m", msg)


def one(src):
    """A single core module: the usual R1 fixture."""
    return {"src/{pkg}/core/foo.py": src}


def purity(src):
    """A single R2 module."""
    return {"src/{pkg}/core/batched/fix.py": src}


# ----------------------------------------------------------------------
# fixtures shared by the port's suite and the parity cases

DT001_BAD = """
    import random
    import numpy as np

    def jitter():
        return np.random.rand(3) + random.random()
"""
DT001_OK = """
    import numpy as np

    def jitter(seed):
        rng = np.random.default_rng(seed)
        return rng.normal(size=3)
"""
DT002_BAD = """
    import time
    import datetime

    def stamp():
        return time.time(), datetime.datetime.now()
"""
DT003_BAD = """
    def order(xs):
        seen = set(xs)
        return [x for x in seen] + [y for y in {1, 2, 3}]
"""
DT003_OK = """
    def order(xs):
        return [x for x in sorted(set(xs))]
"""
INLINE_WAIVER = """
    import time

    T0 = time.time()  # lint: waive[DT002] boot stamp for log headers only
"""
COMMENT_ABOVE_WAIVER = """
    import time

    # lint: waive[DT002] boot stamp only
    T0 = time.time()
"""
FILE_WAIVER = """
    # lint: waive-file[DT002] this module is legitimately wall-clocked
    import time

    def a():
        return time.time()

    def b():
        return time.monotonic()
"""
REASONLESS_WAIVER = """
    import time

    T0 = time.time()  # lint: waive[DT002]
"""
UNKNOWN_RULE_WAIVER = "# lint: waive[XX999] because reasons\nX = 1\n"
UNUSED_WAIVER = "X = 1  # lint: waive[DT001] nothing here\n"
CLOCK_READ = "import time\nT0 = time.time()\n"

SNAP_FIELDS = ("t", "config_id")
SNAP_OK = f"""
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class SimSnapshot:
        SCHEMA_VERSION = 1
        _schema_digest = "{field_digest(SNAP_FIELDS)}"

        t: float
        config_id: int

    @dataclasses.dataclass(frozen=True)
    class EngineSnapshot:
        SCHEMA_VERSION = 1
        _schema_digest = "{field_digest(('sim',))}"

        sim: SimSnapshot
"""
SNAP_BARE = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class SimSnapshot:
        t: float

    @dataclasses.dataclass(frozen=True)
    class EngineSnapshot:
        sim: SimSnapshot
"""
SNAP_STALE = SNAP_OK.replace(field_digest(SNAP_FIELDS), "deadbeef")

PHYSICS_V1 = """
    SIM_VERSION = "sim-1"

    def service_rate(slots):
        return 1.0 * slots
"""
WAL_V1 = """
    WAL_FORMAT = 1

    def encode(rec):
        return repr(rec)
"""


# ----------------------------------------------------------------------
# R1 determinism

def test_dt001_flags_global_state_rng(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, one(DT001_BAD))))
    assert unwaived_rules(report) == ["DT001", "DT001"]
    assert report.exit_code == CATEGORY_BITS["R1"]


def test_dt001_clean_generator_api(tmp_path):
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, one(DT001_OK))))) == []


TORCH_RNG_CASES = [
    ("torch.manual_seed(0)", True),
    ("torch.seed()", True),
    ("torch.random.manual_seed(0)", True),
    ("torch.cuda.manual_seed(0)", True),
    ("torch.cuda.manual_seed_all(0)", True),
    ("torch.rand(3)", True),
    ("torch.rand(3, generator=g)", False),
    ("torch.randn(2, 3, dtype=torch.float32)", True),
    ("torch.randn(2, 3, generator=g, dtype=torch.float32)", False),
    ("torch.randn_like(x)", True),
    ("torch.randint(0, 5, (3,))", True),
    ("torch.randint(0, 5, (3,), generator=g)", False),
    ("torch.randint_like(x, 5)", True),
    ("torch.randperm(5)", True),
    ("torch.randperm(5, generator=g)", False),
    ("torch.bernoulli(x)", True),
    ("torch.bernoulli(x, generator=g)", False),
    ("torch.multinomial(x, 1)", True),
    ("torch.multinomial(x, 1, generator=g)", False),
    ("torch.normal(0.0, 1.0, (3,))", True),
    ("torch.normal(0.0, 1.0, (3,), generator=g)", False),
    ("torch.poisson(x)", True),
    ("x.uniform_(0.0, 1.0)", True),
    ("x.uniform_(0.0, 1.0, generator=g)", False),
    ("x.normal_()", True),
    ("x.normal_(generator=g)", False),
    ("x.bernoulli_(0.5)", True),
    ("x.random_(0, 5)", True),
    ("x.exponential_()", True),
    ("x.exponential_(generator=g)", False),
    ("torch.nn.init.normal_(x)", True),
    ("torch.Generator().manual_seed(0)", False),
    ("g.manual_seed(0)", False),
    ("torch.rand(3, **kw)", False),
    ("torch.zeros(3)", False),
    ("torch.arange(3).random_(generator=g)", False),
]


@pytest.mark.parametrize("call, flagged", TORCH_RNG_CASES, ids=[c for c, _ in TORCH_RNG_CASES])
def test_dt001_torch_default_generator(tmp_path, call, flagged):
    src = f"import torch\n\n\ndef draw(x, g, kw):\n    return {call}\n"
    report = lint_repo(root=str(make_repo(tmp_path, one(src))))
    assert unwaived_rules(report) == (["DT001"] if flagged else [])
    if flagged:
        (v,) = report.violations
        assert (v.line, v.col) == (5, 11)
        assert report.exit_code == CATEGORY_BITS["R1"]


def test_dt001_torch_draw_imported_by_name(tmp_path):
    src = "from torch import randn\n\nX = randn(3)\nY = randn(3, generator=None)\n"
    report = lint_repo(root=str(make_repo(tmp_path, one(src))))
    assert [(v.rule, v.line) for v in report.violations] == [("DT001", 3)]


def test_dt001_torch_out_of_scope_module_is_clean(tmp_path):
    # R1 covers what feeds cell_hash/SimResult/WAL records; a model's init
    # in the training substrate is out, as in the reference
    root = make_repo(tmp_path, {"src/{pkg}/models/foo.py": "import torch\nW = torch.randn(3)\n"})
    assert unwaived_rules(lint_repo(root=str(root))) == []


def test_dt002_flags_wall_clock_reads(tmp_path):
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, one(DT002_BAD))))) == [
        "DT002", "DT002"]


def test_dt002_out_of_scope_module_is_clean(tmp_path):
    root = make_repo(tmp_path, {"src/{pkg}/launch/foo.py": "import time\n\nT0 = time.time()\n"})
    assert unwaived_rules(lint_repo(root=str(root))) == []


def test_dt003_flags_set_iteration(tmp_path):
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, one(DT003_BAD))))) == [
        "DT003", "DT003"]


def test_dt003_clean_sorted_set(tmp_path):
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, one(DT003_OK))))) == []


# ----------------------------------------------------------------------
# R2 trace purity: the reference's fixtures, transcribed line for line

JAX_PURITY_BAD = """
    import jax
    import numpy as np

    @jax.jit
    def bad_print(x):
        print("tracing", x)
        return x + 1

    @jax.jit
    def bad_branch(x):
        if x > 0:
            return x
        return -x

    @jax.jit
    def bad_cast(x):
        return float(x) * 2.0

    @jax.jit
    def bad_np(x):
        return np.sum(x)
"""
TORCH_PURITY_BAD = """
    import torch
    import numpy as np

    @torch.compile
    def bad_print(x):
        print("tracing", x)
        return x + 1

    @torch.compile
    def bad_branch(x):
        if x > 0:
            return x
        return -x

    @torch.compile
    def bad_cast(x):
        return float(x) * 2.0

    @torch.compile
    def bad_np(x):
        return np.sum(x)
"""

JAX_TRANSITIVE = """
    import jax
    import numpy as np

    def helper(x):
        return np.asarray(x)

    @jax.jit
    def entry(x):
        return helper(x) + 1
"""
TORCH_TRANSITIVE = """
    import torch
    import numpy as np

    def helper(x):
        return np.asarray(x)

    @torch.compile
    def entry(x):
        return helper(x) + 1
"""

JAX_FACTORY = """
    import jax

    def make_step():
        def step(carry, x):
            print(carry)
            return carry, x
        return step

    def run(xs):
        step = make_step()
        return jax.lax.scan(step, 0, xs)
"""
TORCH_FACTORY = """
    from torch.utils.checkpoint import checkpoint

    def make_step():
        def step(carry, x):
            print(carry)
            return carry, x
        return step

    def run(xs):
        step = make_step()
        return checkpoint(step, 0, xs, use_reentrant=False)
"""

JAX_CLEAN = """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def good(x, kind: str = "relu"):
        if kind == "relu":  # annotated-static hyperparameter
            return jnp.maximum(x, 0.0)
        return jnp.where(x > 0, x, 0.0)

    def host_side(a):
        # not reachable from any jit/scan/vmap: host numpy is fine
        import numpy as np
        print("host", a)
        return np.sum(a)
"""
TORCH_CLEAN = """
    import torch
    import torch.nn.functional as F

    @torch.compile
    def good(x, kind: str = "relu"):
        if kind == "relu":  # annotated-static hyperparameter
            return F.relu(x)
        return torch.where(x > 0, x, 0.0)

    def host_side(a):
        # not reachable from any compile/vmap/checkpoint: host numpy is fine
        import numpy as np
        print("host", a)
        return np.sum(a)
"""

JAX_STATIC_TESTS = """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def good(x, mask=None):
        if mask is not None:
            x = x * mask
        return jnp.sum(x)
"""
TORCH_STATIC_TESTS = """
    import torch
    import torch.nn.functional as F

    @torch.compile
    def good(x, mask=None):
        if mask is not None:
            x = x * mask
        return torch.sum(x)
"""

# beyond tests/test_lint.py: body kinds (all params and their attributes
# traced), a cond's branches, and a helper reached from a body
JAX_BODY_CARRY = """
    import jax

    def step(state):
        if state.done:
            return state
        return float(state.t)

    def branch_a(x):
        print(x)
        return x

    def run(states, p, x):
        jax.vmap(step)(states)
        return jax.lax.cond(p, branch_a, lambda y: int(y), x)
"""
TORCH_BODY_CARRY = """
    import torch

    def step(state):
        if state.done:
            return state
        return float(state.t)

    def branch_a(x):
        print(x)
        return x

    def run(states, p, x):
        torch.vmap(step)(states)
        return torch.cond(p, branch_a, lambda y: int(y), (x,))
"""

JAX_GLOBAL_WRITE = """
    import jax

    CALLS = 0

    def count(x):
        global CALLS
        CALLS += 1
        return x

    f = jax.jit(count)
"""
TORCH_GLOBAL_WRITE = """
    import torch

    CALLS = 0

    def count(x):
        global CALLS
        CALLS += 1
        return x

    f = torch.compile(count)
"""

PURITY_PAIRS = {
    "bad": (JAX_PURITY_BAD, TORCH_PURITY_BAD, [("JP001", 7), ("JP002", 12), ("JP003", 18),
                                               ("JP004", 22)]),
    "transitive_helper": (JAX_TRANSITIVE, TORCH_TRANSITIVE, [("JP004", 6)]),
    "factory_body": (JAX_FACTORY, TORCH_FACTORY, [("JP001", 6)]),
    "clean": (JAX_CLEAN, TORCH_CLEAN, []),
    "static_under_trace_tests": (JAX_STATIC_TESTS, TORCH_STATIC_TESTS, []),
    "body_carry_and_cond": (JAX_BODY_CARRY, TORCH_BODY_CARRY, [("JP002", 5), ("JP003", 7),
                                                               ("JP001", 10), ("JP003", 15)]),
    "global_write": (JAX_GLOBAL_WRITE, TORCH_GLOBAL_WRITE, [("JP001", 7)]),
}


def _rule_lines(report):
    return sorted((v.rule, v.line) for v in report.violations if not v.waived)


def test_torch_purity_rules_fire(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, purity(TORCH_PURITY_BAD))))
    assert unwaived_rules(report) == ["JP001", "JP002", "JP003", "JP004"]
    assert report.exit_code == CATEGORY_BITS["R2"]


def test_torch_purity_transitive_helper(tmp_path):
    # the np call sits in a helper only *reached* from a compiled entry
    assert "JP004" in unwaived_rules(lint_repo(root=str(make_repo(tmp_path, purity(
        TORCH_TRANSITIVE)))))


def test_torch_purity_checkpoint_body_via_factory(tmp_path):
    # the factory idiom: the traced function is *returned*, never decorated
    assert "JP001" in unwaived_rules(lint_repo(root=str(make_repo(tmp_path, purity(
        TORCH_FACTORY)))))


def test_torch_purity_clean(tmp_path):
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, purity(TORCH_CLEAN))))) == []


def test_torch_purity_static_under_trace_tests_allowed(tmp_path):
    # `is None` / isinstance probe structure, which is static
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, purity(
        TORCH_STATIC_TESTS))))) == []


def test_torch_purity_cross_module_root(tmp_path):
    # a root in one R2 module reaches a helper imported from another
    root = make_repo(tmp_path, {
        "src/{pkg}/models/layer.py": """
            def layer(x):
                return x.item()
        """,
        "src/{pkg}/models/net.py": """
            from torch.utils.checkpoint import checkpoint
            from repro_torch.models.layer import layer

            def forward(x):
                return checkpoint(layer, x, use_reentrant=False)
        """,
    })
    report = lint_repo(root=str(root))
    assert [(v.rule, v.path, v.line) for v in report.violations] == [
        ("JP003", "src/repro_torch/models/layer.py", 3)]


BAD_BODY = "def body(x):\n    print(x)\n    return x\n\n\n"
TORCH_ROOTS = {
    "compile_decorator": "@torch.compile\n" + BAD_BODY,
    "compile_decorator_call": "@torch.compile(mode='reduce-overhead')\n" + BAD_BODY,
    "compile_call": BAD_BODY + "f = torch.compile(body)\n",
    "compile_partial": BAD_BODY + "f = torch.compile(functools.partial(body))\n",
    "func_grad": BAD_BODY + "f = torch.func.grad(body)\n",
    "func_grad_and_value": BAD_BODY + "f = torch.func.grad_and_value(body)\n",
    "func_jacrev": BAD_BODY + "f = torch.func.jacrev(body)\n",
    "func_jacfwd": BAD_BODY + "f = torch.func.jacfwd(body)\n",
    "vmap": BAD_BODY + "f = torch.vmap(body)\n",
    "func_vmap": BAD_BODY + "f = torch.func.vmap(body, in_dims=0)\n",
    "checkpoint": BAD_BODY + "def run(x):\n    return torch.utils.checkpoint.checkpoint(body, x)\n",
    "checkpoint_imported": "from torch.utils.checkpoint import checkpoint as ckpt\n\n\n" + BAD_BODY
    + "def run(x):\n    return ckpt(body, x, use_reentrant=False)\n",
    "make_graphed_callables": BAD_BODY + "f = torch.cuda.make_graphed_callables(body, (x0,))\n",
    "make_graphed_callables_tuple": BAD_BODY
    + "fs = torch.cuda.make_graphed_callables((len, body), ((x0,), (x0,)))\n",
    "cond_true_branch": BAD_BODY + "y = torch.cond(p, body, lambda x: x, (x0,))\n",
    "cond_false_branch": BAD_BODY + "y = torch.cond(p, lambda x: x, body, (x0,))\n",
    "cuda_graph_block": BAD_BODY + "def run(g, x):\n    with torch.cuda.graph(g):\n"
    "        y = body(x)\n    return y\n",
    "cuda_graph_block_nested_call": BAD_BODY + "def run(g, x):\n    with torch.cuda.graph(g):\n"
    "        return torch.relu(body(x))\n",
    "cuda_graph_block_imported": "from torch.cuda import graph\n\n\n" + BAD_BODY
    + "def run(g, x):\n    with graph(g, pool=None):\n        body(x)\n",
}
NOT_ROOTS = {
    "no_transform": BAD_BODY + "def run(x):\n    return body(x)\n",
    "no_grad_block": BAD_BODY + "def run(x):\n    with torch.no_grad():\n        return body(x)\n",
    "vmap_of_other_arg": BAD_BODY + "f = torch.vmap(len, body)\n",
    "cond_predicate_arg": BAD_BODY + "y = torch.cond(body, len, len, (x0,))\n",
    "graph_block_def_not_called": "def run(g):\n    with torch.cuda.graph(g):\n"
    "        def body(x):\n            print(x)\n            return x\n",
}


@pytest.mark.parametrize("name", sorted(TORCH_ROOTS))
def test_torch_root_makes_body_traced(tmp_path, name):
    src = "import functools\nimport torch\n\n\n" + TORCH_ROOTS[name]
    report = lint_repo(root=str(make_repo(tmp_path, purity(src))))
    line = src.splitlines().index("    print(x)") + 1
    assert [(v.rule, v.line) for v in report.violations] == [("JP001", line)]
    assert report.exit_code == CATEGORY_BITS["R2"]


@pytest.mark.parametrize("name", sorted(NOT_ROOTS))
def test_torch_non_root_leaves_body_alone(tmp_path, name):
    src = "import functools\nimport torch\n\n\n" + NOT_ROOTS[name]
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, purity(src))))) == []


HOST_SYNC_CASES = [
    ("return x.item()", "JP003"),
    ("return x.tolist()", "JP003"),
    ("return x.cpu()", "JP003"),
    ("return x.numpy()", "JP003"),
    ("return (x * 2).sum().item()", "JP003"),
    ("return int(x.sum())", "JP003"),
    ("return bool(x)", "JP003"),
    ("return n.item()", None),  # n annotated int: static
    ("return x.size(0)", None),
    ("if x.dim() == 2 and x.size(1) > 4:\n        return x\n    return -x", None),
    ("if x.data_ptr() % 16:\n        return x\n    return -x", None),
    ("if x.numel() == 0 or x.is_contiguous():\n        return x\n    return -x", None),
    ("if x.shape[0] > 1 and x.device.type == 'cuda':\n        return x\n    return -x", None),
    ("if x.sum() > 0:\n        return x\n    return -x", "JP002"),
    ("if y is not None and y.sum() > 0:\n        return x\n    return -x", "JP002"),
    # z is a local: the test is flagged because it calls a torch op
    ("if torch.any(z > 0):\n        return x\n    return -x", "JP002"),
    ("while torch.linalg.norm(z) > 1:\n        z = z / 2\n    return z", "JP002"),
    ("if z.sum() > 0:\n        return x\n    return -x", None),
    ("if torch.cuda.is_available():\n        return x\n    return -x", None),
    ("if torch.is_grad_enabled() and torch.is_tensor(z):\n        return x\n    return -x", None),
    ("if torch.compiler.is_compiling():\n        return x\n    return -x", None),
    ("if torch.finfo(x.dtype).bits == 32:\n        return x\n    return -x", None),
]


@pytest.mark.parametrize("body, rule", HOST_SYNC_CASES, ids=[b.split("\n")[0] for b, _ in
                                                             HOST_SYNC_CASES])
def test_torch_host_syncs_and_tensor_branches(tmp_path, body, rule):
    src = ("import torch\n\n\n@torch.compile\ndef f(x, n: int, y=None):\n"
           f"    z = x * 2\n    {body}\n")
    report = lint_repo(root=str(make_repo(tmp_path, purity(src))))
    assert [(v.rule, v.line) for v in report.violations] == ([(rule, 7)] if rule else [])


ANNOTATION_CASES = [
    ("dev: torch.device", "dev.type == 'cuda'", False),
    ("dtype: torch.dtype", "dtype == torch.float32", False),
    ("dtype: Optional[torch.dtype]", "dtype == torch.float32", False),
    ("impl: str", "impl == 'cuda'", False),
    ("cfg: ArchConfig", "cfg.n_layers > 2", False),
    ("k: int", "k > 2", False),
    ("x: torch.Tensor", "x > 0", True),
    ("x: Optional[torch.Tensor]", "x > 0", True),
    ("x: Union[torch.Tensor, float]", "x > 0", True),
    ("x", "x > 0", True),
]


@pytest.mark.parametrize("param, test, flagged", ANNOTATION_CASES,
                         ids=[p for p, _, _ in ANNOTATION_CASES])
def test_torch_annotations_static_and_traced(tmp_path, param, test, flagged):
    src = ("import torch\nfrom typing import Optional, Union\n\n\n"
           f"def helper({param}):\n    if {test}:\n        return 1\n    return 0\n\n\n"
           "@torch.compile\ndef entry(*args):\n    return helper(*args)\n")
    report = lint_repo(root=str(make_repo(tmp_path, purity(src))))
    assert unwaived_rules(report) == (["JP002"] if flagged else [])


# ----------------------------------------------------------------------
# waivers

def test_inline_waiver_suppresses_and_reports(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, one(INLINE_WAIVER))))
    assert unwaived_rules(report) == []
    assert waived_rules(report) == ["DT002"]
    assert report.exit_code == 0
    (w,) = [v for v in report.violations if v.waived]
    assert w.waive_reason == "boot stamp for log headers only"


def test_comment_above_waiver_covers_next_line(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, one(COMMENT_ABOVE_WAIVER))))
    assert unwaived_rules(report) == [] and waived_rules(report) == ["DT002"]


def test_file_scope_waiver(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, one(FILE_WAIVER))))
    assert unwaived_rules(report) == []
    assert waived_rules(report) == ["DT002", "DT002"]


def test_reasonless_waiver_is_wv001_and_does_not_waive(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, one(REASONLESS_WAIVER))))
    assert unwaived_rules(report) == ["DT002", "WV001"]
    assert report.exit_code == CATEGORY_BITS["R1"] | CATEGORY_BITS["WV"]


def test_unknown_rule_waiver_is_wv001(tmp_path):
    assert unwaived_rules(lint_repo(root=str(make_repo(tmp_path, one(UNKNOWN_RULE_WAIVER))))) == [
        "WV001"]


def test_waiver_example_in_docstring_is_not_parsed():
    fw = parse_waivers("f.py", '"""Use `# lint: waive[DT002] reason` inline."""\n')
    assert not fw.file_scope and not fw.line_scope and not fw.errors


def test_malformed_waiver_is_flagged():
    fw = parse_waivers("f.py", "X = 1  # lint: waive DT002 forgot brackets\n")
    assert [v.rule for v in fw.errors] == ["WV001"]


def test_unused_waiver_noted(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, one(UNUSED_WAIVER))))
    assert report.exit_code == 0
    assert any("unused waiver" in n for n in report.notes)


def test_purity_waiver_suppresses_jp(tmp_path):
    src = TORCH_PURITY_BAD.replace('print("tracing", x)',
                                   'print("tracing", x)  # lint: waive[JP001] trace-time log')
    report = lint_repo(root=str(make_repo(tmp_path, purity(src))))
    assert unwaived_rules(report) == ["JP002", "JP003", "JP004"]
    assert waived_rules(report) == ["JP001"]


# ----------------------------------------------------------------------
# R4 schema drift (static)

def test_sd001_missing_schema_attrs(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, {"src/{pkg}/core/engine.py": SNAP_BARE})))
    # each class: missing SCHEMA_VERSION + missing digest
    assert unwaived_rules(report) == ["SD001"] * 4
    assert report.exit_code == CATEGORY_BITS["R4"]


def test_sd001_clean_with_pinned_digest(tmp_path):
    root = make_repo(tmp_path, {"src/{pkg}/core/engine.py": SNAP_OK})
    assert unwaived_rules(lint_repo(root=str(root))) == []


def test_sd001_stale_digest_names_expected(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, {"src/{pkg}/core/engine.py": SNAP_STALE})))
    assert unwaived_rules(report) == ["SD001"]
    (v,) = [x for x in report.violations if not x.waived]
    assert field_digest(SNAP_FIELDS) in v.message


def test_sd001_moved_class_is_flagged(tmp_path):
    root = make_repo(tmp_path, {"src/{pkg}/service/service.py": "class Other:\n    pass\n"})
    report = lint_repo(root=str(root))
    assert unwaived_rules(report) == ["SD001"]
    assert "SNAPSHOT_REGISTRY" in report.violations[0].message


def test_field_digest_is_order_sensitive():
    assert field_digest(("a", "b")) != field_digest(("b", "a"))
    assert len(field_digest(("a",))) == 8


# ----------------------------------------------------------------------
# R3 version gate (--diff against synthetic git history)

def _git_repo(tmp_path, files, pkg="repro_torch"):
    root = make_repo(tmp_path, files, pkg)
    git(root, "init", "-q")
    commit_all(root)
    return root


def _rewrite(root, rel, src, pkg="repro_torch"):
    (root / rel.format(pkg=pkg)).write_text(textwrap.dedent(src))


SIM = "src/{pkg}/core/simulator.py"


def test_vg001_physics_change_without_bump(tmp_path):
    root = _git_repo(tmp_path, {SIM: PHYSICS_V1})
    _rewrite(root, SIM, PHYSICS_V1.replace("1.0 * slots", "1.1 * slots"))
    report = lint_repo(root=str(root), diff_base="HEAD")
    assert unwaived_rules(report) == ["VG001"]
    assert report.exit_code == CATEGORY_BITS["R3"]
    (v,) = report.violations
    assert "SIM_VERSION" in v.message
    assert v.path == "src/repro_torch/core/simulator.py"


def test_vg001_satisfied_by_version_bump(tmp_path):
    root = _git_repo(tmp_path, {SIM: PHYSICS_V1})
    _rewrite(root, SIM, PHYSICS_V1.replace("1.0 * slots", "1.1 * slots").replace("sim-1", "sim-2"))
    assert unwaived_rules(lint_repo(root=str(root), diff_base="HEAD")) == []


def test_vg001_comment_only_change_is_exempt(tmp_path):
    root = _git_repo(tmp_path, {SIM: PHYSICS_V1})
    _rewrite(root, SIM, PHYSICS_V1.replace(
        "def service_rate(slots):", "def service_rate(slots):\n        # linear speedup model\n"))
    assert unwaived_rules(lint_repo(root=str(root), diff_base="HEAD")) == []


def test_vg001_added_line_waiver(tmp_path):
    root = _git_repo(tmp_path, {SIM: PHYSICS_V1})
    _rewrite(root, SIM, PHYSICS_V1.replace(
        "return 1.0 * slots",
        "# lint: waive[VG001] pure refactor pinned by bit-identity tests\n"
        "        return 1.0 * slots + 0.0"))
    report = lint_repo(root=str(root), diff_base="HEAD")
    assert unwaived_rules(report) == []
    assert waived_rules(report) == ["VG001"]


WAIVED_V1 = PHYSICS_V1.replace(
    "    def service_rate", "    # lint: waive[VG001] historical waiver\n    def service_rate")


def test_vg001_preexisting_waiver_does_not_carry_over(tmp_path):
    # a waiver committed in an earlier PR must not bless later diffs
    root = _git_repo(tmp_path, {SIM: WAIVED_V1})
    _rewrite(root, SIM, WAIVED_V1.replace("1.0 * slots", "1.2 * slots"))
    assert unwaived_rules(lint_repo(root=str(root), diff_base="HEAD")) == ["VG001"]


def test_vg001_batched_physics_module_is_gated(tmp_path):
    # the port's batched step is physics too (core/batched is in the set)
    step = "src/{pkg}/core/batched/backend.py"
    root = _git_repo(tmp_path, {SIM: PHYSICS_V1, step: "def step(x):\n    return x\n"})
    _rewrite(root, step, "def step(x):\n    return x + 0\n")
    assert unwaived_rules(lint_repo(root=str(root), diff_base="HEAD")) == ["VG001"]


WAL = "src/{pkg}/service/records.py"


def test_vg002_wal_change_without_format_bump(tmp_path):
    root = _git_repo(tmp_path, {WAL: WAL_V1})
    _rewrite(root, WAL, WAL_V1.replace("return repr(rec)", 'return repr(rec) + "\\n"'))
    report = lint_repo(root=str(root), diff_base="HEAD")
    assert unwaived_rules(report) == ["VG002"]
    (v,) = report.violations
    assert "WAL_FORMAT" in v.message


ENGINE = "src/{pkg}/core/engine.py"
SNAP_GROWN = SNAP_OK.replace("t: float", "t: float\n        num_slices: int").replace(
    field_digest(SNAP_FIELDS), field_digest(("t", "num_slices", "config_id")))


def test_sd002_field_change_without_schema_bump(tmp_path):
    root = _git_repo(tmp_path, {ENGINE: SNAP_OK})
    _rewrite(root, ENGINE, SNAP_GROWN)
    report = lint_repo(root=str(root), diff_base="HEAD")
    # engine.py is also a physics file, so the no-bump edit trips VG001 too
    assert "SD002" in unwaived_rules(report)
    sd = [v for v in report.violations if v.rule == "SD002"]
    assert "SCHEMA_VERSION" in sd[0].message


def test_diff_gate_unfetchable_base_fails_loudly(tmp_path):
    root = _git_repo(tmp_path, {SIM: PHYSICS_V1})
    report = lint_repo(root=str(root), diff_base="origin/nonexistent")
    assert unwaived_rules(report) == ["VG001"]
    assert "fetch" in report.violations[0].message


def test_ast_fingerprint_ignores_docstrings():
    a = ast_fingerprint('def f():\n    """doc one."""\n    return 1\n')
    b = ast_fingerprint('def f():\n    """different doc."""\n    return 1\n')
    c = ast_fingerprint("def f():\n    return 2\n")
    assert a == b and a != c
    assert ast_fingerprint("def broken(:\n") is None


# ----------------------------------------------------------------------
# report schema / CLI / exit codes

def test_json_report_schema(tmp_path):
    d = lint_repo(root=str(make_repo(tmp_path, one(CLOCK_READ)))).to_dict()
    assert d["version"] == 1
    assert set(d) == {"version", "files_checked", "violations", "summary", "notes", "exit_code"}
    assert d["summary"]["total"] == d["summary"]["unwaived"] == 1
    assert d["summary"]["by_category"] == {"R1": 1}
    (v,) = d["violations"]
    assert set(v) >= {"rule", "category", "path", "line", "col", "message", "waived"}
    json.dumps(d)  # must be serializable as-is


def test_cli_json_and_exit_code(tmp_path, capsys):
    from repro_torch.lint.__main__ import main

    root = make_repo(tmp_path, one(CLOCK_READ))
    code = main(["--root", str(root), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert code == out["exit_code"] == CATEGORY_BITS["R1"]


def test_cli_human_output_and_list_rules(tmp_path, capsys):
    from repro_torch.lint.__main__ import main

    root = make_repo(tmp_path, one(CLOCK_READ))
    assert main(["--root", str(root)]) == 1
    out = capsys.readouterr().out
    assert "DT002" in out and "1 violation(s)" in out and "repro_torch.lint:" in out

    assert main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    for rule in RULES:
        assert rule in listing


def test_cli_paths_and_diff_flags(tmp_path, capsys):
    from repro_torch.lint.__main__ import main

    root = _git_repo(tmp_path, {SIM: PHYSICS_V1, "src/{pkg}/core/foo.py": CLOCK_READ})
    _rewrite(root, SIM, PHYSICS_V1.replace("1.0 * slots", "1.1 * slots"))
    # a path argument narrows the static sweep; --diff adds the gate
    assert main(["--root", str(root), "src/repro_torch/core/simulator.py"]) == 0
    assert main(["--root", str(root), "src/repro_torch/core/simulator.py", "--diff", "HEAD"]) == 4
    assert main(["--root", str(root)]) == 1
    capsys.readouterr()


def test_cli_runs_as_module_without_jax(tmp_path):
    # python -m repro_torch.lint in a fresh interpreter that cannot import jax
    root = make_repo(tmp_path, one(CLOCK_READ))
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.lint.__main__ import main\n"
            f"sys.exit(main(['--root', {str(root)!r}, '--json']))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=tmp_path)
    assert proc.returncode == CATEGORY_BITS["R1"], proc.stderr
    assert json.loads(proc.stdout)["summary"]["unwaived"] == 1


def test_exit_code_is_bitwise_or_of_categories(tmp_path):
    root = make_repo(tmp_path, {"src/{pkg}/core/foo.py": CLOCK_READ,
                                "src/{pkg}/core/batched/fix.py": TORCH_PURITY_BAD})
    assert lint_repo(root=str(root)).exit_code == CATEGORY_BITS["R1"] | CATEGORY_BITS["R2"]


def test_exit_code_for_ignores_waived():
    v = Violation("DT001", "f.py", 1, 0, "m", waived=True, waive_reason="r")
    assert exit_code_for([v]) == 0
    assert exit_code_for([Violation("LE001", "f.py", 1, 0, "m")]) == 64


def test_syntax_error_is_le001(tmp_path):
    report = lint_repo(root=str(make_repo(tmp_path, {"src/{pkg}/core/bad.py": "def broken(:\n"})))
    assert unwaived_rules(report) == ["LE001"]
    assert report.exit_code == CATEGORY_BITS["internal"]


def test_rule_registry_categories_consistent():
    for rule in RULES:
        assert category_of(rule) in CATEGORY_BITS


def test_registry_ids_and_bits_are_the_references():
    assert CATEGORY_BITS == ref_lint.CATEGORY_BITS
    assert set(RULES) == set(ref_lint.RULES)
    assert {r: c for r, (c, _) in RULES.items()} == {r: c for r, (c, _) in ref_lint.RULES.items()}


def test_docs_catalog_in_sync_with_registry():
    doc = (REPO_ROOT / "docs" / "LINTING_TORCH.md").read_text()
    for rule, (cat, summary) in RULES.items():
        assert f"| {rule} | {cat} | {summary} |" in doc, f"{rule} row missing from LINTING_TORCH.md"


# ----------------------------------------------------------------------
# parity with the JAX package's analyzer

def _both(tmp_path, files):
    """Lay ``files`` out once under src/repro/ and once under src/repro_torch/
    and lint each tree with its own package's analyzer."""
    ref_root = make_repo(tmp_path / "ref", files, "repro")
    port_root = make_repo(tmp_path / "port", files, "repro_torch")
    return ref_lint.lint_repo(root=str(ref_root)), lint_repo(root=str(port_root))


def _rlc(report):
    return sorted((v.rule, v.line, v.col, v.waived) for v in report.violations)


SHARED_STATIC = {
    "dt001_bad": one(DT001_BAD),
    "dt001_ok": one(DT001_OK),
    "dt002_bad": one(DT002_BAD),
    "dt002_out_of_scope": {"src/{pkg}/launch/foo.py": "import time\n\nT0 = time.time()\n"},
    "dt003_bad": one(DT003_BAD),
    "dt003_ok": one(DT003_OK),
    "inline_waiver": one(INLINE_WAIVER),
    "comment_above_waiver": one(COMMENT_ABOVE_WAIVER),
    "file_waiver": one(FILE_WAIVER),
    "reasonless_waiver": one(REASONLESS_WAIVER),
    "unknown_rule_waiver": one(UNKNOWN_RULE_WAIVER),
    "unused_waiver": one(UNUSED_WAIVER),
    "malformed_waiver": one("X = 1  # lint: waive DT002 forgot brackets\n"),
    "sd001_bare": {"src/{pkg}/core/engine.py": SNAP_BARE},
    "sd001_ok": {"src/{pkg}/core/engine.py": SNAP_OK},
    "sd001_stale": {"src/{pkg}/core/engine.py": SNAP_STALE},
    "sd001_service_stats_missing": {"src/{pkg}/service/service.py": "X = 1\n"},
    "le001": {"src/{pkg}/core/bad.py": "def broken(:\n"},
    "fleet_and_service_scopes": {
        "src/{pkg}/fleet/a.py": DT002_BAD, "src/{pkg}/forecast/b.py": DT003_BAD,
        "src/{pkg}/sweep/c.py": DT001_BAD, "src/{pkg}/service/d.py": CLOCK_READ},
}


@pytest.mark.parametrize("name", sorted(SHARED_STATIC))
def test_parity_static_rules(tmp_path, name):
    ref, port = _both(tmp_path, SHARED_STATIC[name])
    assert _rlc(port) == _rlc(ref)
    assert port.exit_code == ref.exit_code
    assert port.files_checked == ref.files_checked
    assert [n.replace("repro_torch", "repro") for n in port.notes] == ref.notes


SHARED_DIFF = {
    "vg001_no_bump": ({SIM: PHYSICS_V1}, {SIM: PHYSICS_V1.replace("1.0 * slots", "1.1 * slots")}),
    "vg001_bumped": ({SIM: PHYSICS_V1}, {SIM: PHYSICS_V1.replace("1.0 * slots", "1.1 * slots")
                                         .replace("sim-1", "sim-2")}),
    "vg001_comment_only": ({SIM: PHYSICS_V1}, {SIM: PHYSICS_V1.replace(
        "def service_rate(slots):", "def service_rate(slots):\n        # linear speedup model\n")}),
    "vg001_added_waiver": ({SIM: PHYSICS_V1}, {SIM: PHYSICS_V1.replace(
        "return 1.0 * slots", "# lint: waive[VG001] pure refactor pinned by bit-identity tests\n"
        "        return 1.0 * slots + 0.0")}),
    "vg001_old_waiver": ({SIM: WAIVED_V1}, {SIM: WAIVED_V1.replace("1.0 * slots", "1.2 * slots")}),
    "vg002_no_bump": ({WAL: WAL_V1}, {WAL: WAL_V1.replace("repr(rec)", "repr(rec) + '!'")}),
    "vg002_bumped": ({WAL: WAL_V1}, {WAL: WAL_V1.replace("repr(rec)", "repr(rec) + '!'")
                                     .replace("WAL_FORMAT = 1", "WAL_FORMAT = 2")}),
    "sd002_no_bump": ({ENGINE: SNAP_OK}, {ENGINE: SNAP_GROWN}),
    "sd002_bumped": ({ENGINE: SNAP_OK}, {ENGINE: SNAP_GROWN.replace(
        "SCHEMA_VERSION = 1", "SCHEMA_VERSION = 2", 1)}),
}


@pytest.mark.parametrize("name", sorted(SHARED_DIFF))
def test_parity_diff_gate(tmp_path, name):
    before, after = SHARED_DIFF[name]
    reports = []
    for pkg, lint in (("repro", ref_lint.lint_repo), ("repro_torch", lint_repo)):
        root = _git_repo(tmp_path / pkg, before, pkg)
        for rel, src in after.items():
            _rewrite(root, rel, src, pkg)
        reports.append(lint(root=str(root), diff_base="HEAD"))
    ref, port = reports
    assert _rlc(port) == _rlc(ref)
    assert port.exit_code == ref.exit_code


def test_parity_diff_gate_unfetchable_base(tmp_path):
    ref_root = _git_repo(tmp_path / "ref", {SIM: PHYSICS_V1}, "repro")
    port_root = _git_repo(tmp_path / "port", {SIM: PHYSICS_V1})
    ref = ref_lint.lint_repo(root=str(ref_root), diff_base="origin/nonexistent")
    port = lint_repo(root=str(port_root), diff_base="origin/nonexistent")
    assert _rlc(port) == _rlc(ref)


@pytest.mark.parametrize("name", sorted(PURITY_PAIRS))
def test_parity_purity_transcriptions(tmp_path, name):
    jax_src, torch_src, expected = PURITY_PAIRS[name]
    assert len(jax_src.splitlines()) == len(torch_src.splitlines())
    ref = ref_lint.lint_repo(root=str(make_repo(tmp_path / "ref", purity(jax_src), "repro")))
    port = lint_repo(root=str(make_repo(tmp_path / "port", purity(torch_src))))
    assert _rule_lines(port) == _rule_lines(ref) == sorted(expected)
    assert port.exit_code == ref.exit_code


DIGEST_INPUTS = [(), ("a",), ("a", "b"), ("b", "a"), SNAP_FIELDS, ("sim",),
                 ("num_completed", "energy_kwh", "ütf8")]


@pytest.mark.parametrize("fields", DIGEST_INPUTS, ids=[",".join(f) or "empty" for f in
                                                       DIGEST_INPUTS])
def test_parity_field_digest(fields):
    assert field_digest(fields) == ref_field_digest(fields)


FINGERPRINT_INPUTS = [
    None,
    "",
    "def broken(:\n",
    'def f():\n    """doc one."""\n    return 1\n',
    "class A:\n    '''doc'''\n    x: int = 1\n\n    def g(self):\n        '''d'''\n",
    '"""module doc"""\nimport os\nX = os.sep  # comment\n',
]


@pytest.mark.parametrize("source", FINGERPRINT_INPUTS, ids=range(len(FINGERPRINT_INPUTS)))
def test_parity_ast_fingerprint(source):
    assert ast_fingerprint(source) == ref_ast_fingerprint(source)


@pytest.mark.parametrize("path, classname", SNAPSHOT_REGISTRY, ids=[c for _, c in
                                                                    SNAPSHOT_REGISTRY])
def test_port_snapshot_digests_equal_the_references(path, classname):
    ref_path = path.replace("src/repro_torch/", "src/repro/")
    port = extract_schema(ast.parse((REPO_ROOT / path).read_text()), classname)
    ref = ref_extract_schema(ast.parse((REPO_ROOT / ref_path).read_text()), classname)
    fields, digest, version, _ = port
    ref_fields, ref_digest, ref_version, _ = ref
    assert (fields, digest, version) == (ref_fields, ref_digest, ref_version)
    assert digest == field_digest(fields)


def test_port_snapshot_digests_at_runtime():
    from repro_torch.core.engine import EngineSnapshot, SimSnapshot
    from repro_torch.service.service import ServiceStats

    for cls in (SimSnapshot, EngineSnapshot, ServiceStats):
        names = tuple(f.name for f in dataclasses.fields(cls))
        assert cls._schema_digest == field_digest(names)
        assert cls.SCHEMA_VERSION == 1
        assert "_schema_digest" not in names and "SCHEMA_VERSION" not in names


# ----------------------------------------------------------------------
# the sweep of the real tree

@pytest.fixture(scope="module")
def real_report():
    return lint_repo(root=str(REPO_ROOT))


def test_repo_sweep_is_clean(real_report):
    offenders = [v for v in real_report.violations if not v.waived]
    assert not offenders, "\n".join(f"{v.path}:{v.line}: {v.rule} {v.message}" for v in offenders)
    assert real_report.exit_code == 0
    assert real_report.files_checked > 100
    # every waiver in the tree must carry its justification
    for v in real_report.violations:
        if v.waived:
            assert v.waive_reason
    assert not real_report.notes


def test_repo_sweep_covers_the_ports_files(real_report):
    port_files = sorted((REPO_ROOT / "src" / "repro_torch").rglob("*.py"))
    assert real_report.files_checked == len(port_files) + 2  # + chip_smoke.py, the 4-card script


_WAIVER = re.compile(r"\s*#\s*lint:\s*waive(-file)?\[[A-Za-z0-9_,\s]+\].*$")


def _strip_waiver(path: Path, rule: str, line: int) -> None:
    """Remove the waiver that covers ``rule`` at ``line``: on that line, the
    line above, or a file waiver; line numbers stay as they were."""
    lines = path.read_text().split("\n")
    for i in (line - 1, line - 2):
        if re.search(rf"#\s*lint:\s*waive\[[^\]]*\b{rule}\b", lines[i]):
            lines[i] = _WAIVER.sub("", lines[i])
            break
    else:
        (i,) = [i for i, s in enumerate(lines)
                if re.search(rf"#\s*lint:\s*waive-file\[[^\]]*\b{rule}\b", s)]
        lines[i] = _WAIVER.sub("", lines[i])
    path.write_text("\n".join(lines))


def _copy(tmp_path, rels):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel in rels:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(REPO_ROOT / rel, dst)
    return tmp_path


#: the wall-clock reads the port waives: (file, waived DT002 findings)
DT002_SITES = {
    "core/rl/batched_train.py": 4,
    "core/rl/train.py": 4,
    "service/clock.py": 1,
    "service/server.py": 2,
    "sweep/__main__.py": 2,
    "sweep/batched.py": 2,
    "sweep/cells.py": 3,
    "sweep/runner.py": 3,
}
#: the R2 findings the port waives: (file, rule) -> count
R2_SITES = {("kernels/gmm.py", "JP001"): 2, ("kernels/ops.py", "JP002"): 2,
            ("kernels/ref.py", "JP003"): 1}
WAIVED = {**{(f, "DT002"): n for f, n in DT002_SITES.items()}, **R2_SITES}
WAIVER_CASES = [(f, rule, k) for (f, rule), n in WAIVED.items() for k in range(n)]


def _r2_files():
    return sorted(p.relative_to(REPO_ROOT).as_posix() for prefix in R2_PATHS
                  for p in (REPO_ROOT / prefix).rglob("*.py"))


@pytest.mark.parametrize("rel, rule, k", WAIVER_CASES,
                         ids=[f"{f}:{r}#{k}" for f, r, k in WAIVER_CASES])
def test_removing_a_waiver_brings_the_finding_back(tmp_path, rel, rule, k):
    count = WAIVED[(rel, rule)]
    rel = f"src/repro_torch/{rel}"
    # R1 is per file; R2 needs the call graph, so every R2 module comes along
    root = _copy(tmp_path, [rel] if rule == "DT002" else _r2_files())
    before = lint_repo(root=str(root))
    assert before.exit_code == 0
    sites = sorted(v.line for v in before.violations
                   if v.waived and v.rule == rule and v.path == rel)
    assert len(sites) == count
    line = sites[k]
    _strip_waiver(root / rel, rule, line)
    after = lint_repo(root=str(root))
    back = [(v.rule, v.path, v.line) for v in after.violations if not v.waived]
    assert (rule, rel, line) in back
    assert after.exit_code == CATEGORY_BITS[category_of(rule)]


@pytest.mark.parametrize("path, classname", SNAPSHOT_REGISTRY, ids=[c for _, c in
                                                                    SNAPSHOT_REGISTRY])
def test_removing_a_digest_brings_sd001_back(tmp_path, path, classname):
    root = _copy(tmp_path, [path])
    assert lint_repo(root=str(root)).exit_code == 0
    _, digest, _, cls_line = extract_schema(ast.parse((root / path).read_text()), classname)
    lines = (root / path).read_text().split("\n")
    # the class's own digest: the first one below its header
    i = next(i for i in range(cls_line, len(lines)) if "_schema_digest =" in lines[i])
    assert digest in lines[i]
    lines[i] = ""
    (root / path).write_text("\n".join(lines))
    report = lint_repo(root=str(root))
    assert [(v.rule, v.line) for v in report.violations if not v.waived] == [("SD001", cls_line)]
    assert digest in report.violations[0].message
    assert report.exit_code == CATEGORY_BITS["R4"]


#: the parameters gmm's route and checks branch on
ANNOTATION_FIXES = [("_plan", "dtype"), ("_check", "out_dtype")]


@pytest.mark.parametrize("func, param", ANNOTATION_FIXES, ids=[f"{f}.{p}" for f, p in
                                                               ANNOTATION_FIXES])
def test_removing_a_dtype_annotation_brings_jp002_back(tmp_path, func, param):
    # gmm's route and checks read torch.dtype parameters, static under a trace
    root = _copy(tmp_path, _r2_files())
    path = root / "src/repro_torch/kernels/gmm.py"
    src = path.read_text()
    sig = re.search(rf"def {func}\(([^)]*)\)", src)
    assert f"{param}: torch.dtype" in sig.group(1)
    new_sig = re.sub(rf"\b{param}: torch\.dtype", param, sig.group(0))
    path.write_text(src.replace(sig.group(0), new_sig))
    report = lint_repo(root=str(root))
    back = [(v.rule, v.path) for v in report.violations if not v.waived]
    assert back and set(back) == {("JP002", "src/repro_torch/kernels/gmm.py")}
    assert report.exit_code == CATEGORY_BITS["R2"]
