"""Scope registry: which files each rule category applies to.

All paths are repo-root-relative posix.  The sets mirror the contracts in
CONTRIBUTING.md / DESIGN.md:

* ``R1`` (determinism) covers every module whose output feeds ``cell_hash``
  (sweep cells), ``SimResult`` (the simulation core, fleet, forecast,
  serving), or WAL records (the service).  The JAX package's two gate
  scripts have no counterpart in the port.  The training substrate
  (models/kernels/launch/…) is deliberately out: it never feeds a gated
  number, and seeding there is covered by R2's purity rules where it
  matters.
* ``R2`` (trace purity) covers the modules whose code reaches a torch
  trace, a CUDA-graph capture or a checkpoint recompute.
* ``R3`` physics set = every module a SIM_VERSION bump covers per
  CONTRIBUTING.md ("When to bump SIM_VERSION"); WAL set likewise for
  WAL_FORMAT.
* ``R4`` registry = the pickled snapshot dataclasses.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

__all__ = [
    "DEFAULT_TARGETS",
    "R1_PATHS",
    "R2_PATHS",
    "PHYSICS_PATHS",
    "WAL_PATHS",
    "SIM_VERSION_FILE",
    "WAL_FORMAT_FILE",
    "SNAPSHOT_REGISTRY",
    "find_repo_root",
    "in_scope",
]

#: what a bare ``python -m repro_torch.lint`` sweeps: the port's own files
#: (tests/ hosts deliberately bad fixture snippets and is excluded by design)
DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py", "scripts/torch_sharded_cards.py")

#: R1 determinism scope — prefixes (dirs) and exact files
R1_PATHS = (
    "src/repro_torch/core",
    "src/repro_torch/fleet",
    "src/repro_torch/forecast",
    "src/repro_torch/sweep",
    "src/repro_torch/service",
)

#: R2 purity scope — the modules whose code reaches a trace, a graph
#: capture or a checkpoint recompute
R2_PATHS = (
    "src/repro_torch/core/batched",
    "src/repro_torch/core/rl",
    "src/repro_torch/kernels",
    "src/repro_torch/optim",
    "src/repro_torch/models",
)

#: R3 physics set: a semantically visible change here requires a
#: SIM_VERSION bump (CONTRIBUTING.md) or an explicit in-diff waiver
PHYSICS_PATHS = (
    "src/repro_torch/core/simulator.py",
    "src/repro_torch/core/slices.py",
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/schedulers.py",
    "src/repro_torch/core/workload.py",
    "src/repro_torch/core/scenarios.py",
    "src/repro_torch/core/power.py",
    "src/repro_torch/core/jobs.py",
    "src/repro_torch/core/metrics.py",
    "src/repro_torch/core/serving.py",
    "src/repro_torch/core/batched",
    "src/repro_torch/fleet",
    "src/repro_torch/forecast",
)

#: R3 WAL set: record/WAL codec changes require a WAL_FORMAT bump
WAL_PATHS = (
    "src/repro_torch/service/records.py",
    "src/repro_torch/service/wal.py",
)

SIM_VERSION_FILE = "src/repro_torch/core/simulator.py"
WAL_FORMAT_FILE = "src/repro_torch/service/records.py"

#: R4: pickled snapshot dataclasses that must carry SCHEMA_VERSION +
#: _schema_digest class attributes (file, class name)
SNAPSHOT_REGISTRY: Tuple[Tuple[str, str], ...] = (
    ("src/repro_torch/core/engine.py", "SimSnapshot"),
    ("src/repro_torch/core/engine.py", "EngineSnapshot"),
    ("src/repro_torch/service/service.py", "ServiceStats"),
)


def find_repo_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default cwd) to the dir holding pyproject.toml."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise FileNotFoundError(
                "repro_torch.lint could not locate the repo root (no pyproject.toml "
                "above the current directory); run from inside the repo or "
                "pass --root"
            )
        d = parent


def in_scope(rel_path: str, prefixes) -> bool:
    """True when repo-relative ``rel_path`` matches a file or dir prefix."""
    for p in prefixes:
        if rel_path == p or rel_path.startswith(p.rstrip("/") + "/"):
            return True
    return False


def iter_python_files(root: str, targets) -> List[str]:
    """Repo-relative posix paths of .py files under the given targets."""
    out: List[str] = []
    for target in targets:
        abs_t = os.path.join(root, target)
        if os.path.isfile(abs_t):
            if abs_t.endswith(".py"):
                out.append(os.path.relpath(abs_t, root).replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(abs_t):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    out.append(rel.replace(os.sep, "/"))
    return sorted(set(out))
