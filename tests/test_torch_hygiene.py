"""The port imports neither JAX nor the JAX package ``repro`` (``repro_torch`` is fine),
nor ``ml_dtypes``, which comes with JAX and is absent on the card's machine.

Nor do ``tests/torch_rl_golden.py``, ``tests/torch_sweep_golden.py`` and
``tests/torch_service_golden.py``, which ``chip_smoke.py`` imports on a machine
without JAX."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_rl_golden.py", ROOT / "tests" / "torch_sweep_golden.py",
    ROOT / "tests" / "torch_service_golden.py"]
BANNED = ("jax", "repro", "ml_dtypes")


def _banned(module: str) -> bool:
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def forbidden_imports(source: str) -> list:
    """Names of JAX / ``repro`` modules that ``source`` imports, statically or by name."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _banned(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _banned(arg.value.rstrip(".") or "x")):
                found.append(arg.value)
    return found


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu").exists()
    listed = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"src/repro_torch/core/{m}.py" for m in
            ("slices", "scenarios", "batched/backend", "batched/tables")} <= listed
    assert {f"src/repro_torch/{m}.py" for m in
            ("core/rl/__init__", "core/rl/env", "core/rl/dqn", "core/rl/batched_train",
             "core/batched/env", "optim/__init__", "optim/adamw", "optim/schedule",
             "launch/train_rl", "core/engine", "core/schedulers", "core/rl/agent",
             "core/rl/train", "forecast/forecaster", "forecast/policy", "sweep/cells",
             "launch/cluster_sim", "launch/evaluate", "tree", "data/pipeline",
             "checkpoint/store", "distributed/step", "launch/train", "sweep/cache",
             "sweep/batched", "sweep/runner", "sweep/grids", "sweep/__main__", "service/__init__",
             "service/records", "service/wal", "service/checkpoint", "service/clock", "service/service",
             "service/server", "service/__main__", "cluster/__init__", "cluster/pod", "cluster/elasticity",
             "cluster/workload", "distributed/fault_tolerance", "launch/shapes",
             "distributed/sharding", "distributed/hints", "distributed/compression",
             "launch/mesh", "launch/dryrun", "analysis/constants", "analysis/roofline",
             "configs/paper_a100")} <= listed
    assert {f"src/repro_torch/lint/{m}.py" for m in
            ("__init__", "__main__", "base", "determinism", "purity", "schema", "version_gate",
             "waivers", "paths")} <= listed


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    assert forbidden_imports(path.read_text()) == [], path


@pytest.mark.parametrize("source, bad", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import numpy", True),
    ("from jax.experimental import pallas as pl", True),
    ("import repro", True),
    ("from repro.models import config", True),
    ("import repro.kernels.ops as ops", True),
    ("import importlib\nimportlib.import_module('repro.configs.gemma3_1b')", True),
    ("import importlib\nimportlib.import_module(f'repro.configs.{name}')", True),
    ("import repro_torch", False),
    ("from repro_torch.models import config", False),
    ("import importlib\nimportlib.import_module(f'repro_torch.configs.{name}')", False),
    ("import jaxlib_free_module", False),
    ("import ml_dtypes", True),
    ("from ml_dtypes import bfloat16", True),
    ("from . import ops", False),
])
def test_checker_flags_exactly_jax_and_repro(source, bad):
    assert bool(forbidden_imports(source)) is bad
