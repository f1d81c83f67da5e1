"""Build ``csrc/*.cu`` with nvcc into shared libraries and load them with ctypes.

Each source becomes its own ``build/kernels/<stem>-<hash>.so`` at the repo
root (gitignored), where the hash covers the source, every header in
``csrc/`` and the flags, so an edited kernel rebuilds and an unchanged one
loads from the cache. All missing libraries are built together, one ``nvcc``
process per source, started at once. The sources expose a plain C interface,
so no PyTorch header is compiled (seconds, not minutes).

Importing this module needs no ``nvcc``: the build runs at a kernel's first
launch, or when :func:`build_all` is called.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "Built", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    """One built library: where it is, how long nvcc took (0 when cached),
    and the ``ptxas -v`` lines (registers, shared memory, spills)."""

    name: str
    path: Path
    seconds: float
    cached: bool
    ptxas: List[str]


_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> List[str]:
    """Per kernel: its (mangled) name, then registers and spills."""
    keep = ("Compiling entry function", "Used", "spill")
    return [" ".join(ln.split()) for ln in log.splitlines() if any(k in ln for k in keep)]


def build_all() -> Dict[str, Built]:
    """Build every ``csrc/*.cu`` whose library is not cached, in parallel."""
    built: Dict[str, Built] = {}
    pending = []
    for src in sorted(CSRC.glob("*.cu")):
        target = _target(src)
        log = target.with_suffix(".log")
        if target.exists():
            text = log.read_text() if log.exists() else ""
            built[src.stem] = Built(src.stem, target, 0.0, True, _ptxas_lines(text))
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((src, target, tmp, proc, time.perf_counter()))
    failures = []
    for src, target, tmp, proc, t0 in pending:
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        target.with_suffix(".log").write_text(out)
        built[src.stem] = Built(src.stem, target, seconds, False, _ptxas_lines(out))
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building it first if needed)."""
    if name not in _LIBS:
        built = build_all()
        if name not in built:
            raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
        _LIBS[name] = ctypes.CDLL(str(built[name].path))
    return _LIBS[name]
