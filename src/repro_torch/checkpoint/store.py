"""Checkpoint store: flat-key npz shards + JSON manifest (``repro.checkpoint.store``'s counterpart).

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

* the tree is flattened to ``path/to/leaf`` keys in JAX's order
  (:mod:`repro_torch.tree`: dict keys, NamedTuple field names, list and
  tuple indices),
* leaves are written in npz *shards* of at most 1 GiB each,
* ``manifest.json`` records ``step``, each key's ``shape``, logical
  ``dtype`` and ``shard``, ``num_shards``, ``extra`` and ``written_at``,
* a checkpoint is written into ``step_%08d.tmp`` and published by renaming
  it to ``step_%08d`` (atomic),
* bf16 leaves are stored as ``uint16`` views under the logical dtype name
  ``"bfloat16"``, as the reference stores its ``ml_dtypes`` arrays; here
  through ``Tensor.view``, with no ``ml_dtypes``.

Restore takes a *target* tree of tensors (meta or real) and casts each leaf
to the target's dtype on the target device. ``CheckpointManager.save_async``
copies the tree to the host before its writer thread starts, so training
may overwrite its tensors at once.

**Elastic resume**, as the reference's: a tree of DTensors is saved as full
tensors (every rank gathers them, rank 0 writes), and ``restore_checkpoint``
takes an optional spec tree (:mod:`repro_torch.distributed.sharding`) that
places each leaf on the target mesh, whatever mesh wrote it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.hints import get_ambient_mesh
from repro_torch.distributed.sharding import placements, spec_leaves
from repro_torch.tree import flatten_with_paths, path_key, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

_SHARD_BYTES = 1 << 30  # 1 GiB per npz shard

# key -> (the array as stored, its logical dtype name)
Flat = Dict[str, Tuple[np.ndarray, str]]


def _host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as stored, and its logical dtype name (a
    DTensor gathered whole first: a collective, on every rank)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits as uint16
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _flatten(tree: Any) -> Flat:
    return {path_key(path): _host(leaf) for path, leaf in flatten_with_paths(tree)}


def _tensor(stored: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(stored.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(stored)


def _write(directory: str, step: int, flat: Flat, extra: Optional[Dict]) -> str:
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    shards: List[Dict[str, np.ndarray]] = [{}]
    sizes = [0]
    for k, (v, _) in flat.items():
        if sizes[-1] + v.nbytes > _SHARD_BYTES and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += v.nbytes

    manifest = {
        "step": step,
        "keys": {
            k: {"shape": list(v.shape), "dtype": flat[k][1], "shard": si}
            for si, sh in enumerate(shards)
            for k, v in sh.items()
        },
        "num_shards": len(shards),
        "extra": extra or {},
        "written_at": time.time(),
    }
    for si, sh in enumerate(shards):
        np.savez(os.path.join(tmp_dir, f"shard_{si:04d}.npz"), **sh)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_dir, ckpt_dir)  # atomic publish
    return ckpt_dir


def _writes() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
    """Write one checkpoint of ``tree`` (a tree of tensors); returns its directory.

    In a process group every rank calls it (DTensor leaves are gathered),
    rank 0 writes, and every rank returns once the checkpoint is published."""
    flat = _flatten(tree)
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    if _writes():
        ckpt_dir = _write(directory, step, flat, extra)
    if dist.is_initialized():
        dist.barrier()
    return ckpt_dir


def _steps(directory: str) -> List[int]:
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(
    directory: str, step: int, target_tree: Any, shardings: Optional[Any] = None, *,
    mesh: Optional[Any] = None, device: DeviceLike = None,
) -> Any:
    """Restore into the structure of ``target_tree`` (tensors, meta or real).

    Each leaf takes the target's shape (else ``ValueError``) and dtype (a
    cast) and lands on ``device`` (the card unless the caller passes
    ``"cpu"``). A target leaf the checkpoint lacks raises ``KeyError``.

    ``shardings`` (a spec tree shaped as ``target_tree``) enables elastic
    resume: each leaf is placed on ``mesh`` (default: the ambient mesh) with
    its spec, regardless of the mesh that wrote the checkpoint; ``device``
    is then the mesh's device type.
    """
    if shardings is not None:
        mesh = mesh if mesh is not None else get_ambient_mesh()
        if mesh is None:
            raise ValueError("restore_checkpoint: shardings need a mesh (none given or set)")
        device = mesh.device_type
    dev = resolve_device(device)
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    shard_files = [
        np.load(os.path.join(ckpt_dir, f"shard_{si:04d}.npz"))
        for si in range(manifest["num_shards"])
    ]
    out_leaves = []
    for path, leaf in flatten_with_paths(target_tree):
        key = path_key(path)
        info = manifest["keys"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        shape = tuple(info["shape"])
        if shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint {shape} != target {tuple(leaf.shape)}")
        t = _tensor(shard_files[info["shard"]][key], info["dtype"])
        out_leaves.append(t.to(dev, dtype=leaf.dtype))
    if shardings is not None:
        specs = spec_leaves(shardings)
        out_leaves = [distribute_tensor(t, mesh, placements(s, mesh))
                      for t, s in zip(out_leaves, specs, strict=True)]
    return unflatten(target_tree, out_leaves)


class CheckpointManager:
    """Async writer + retention policy (keep last N).

    ``timings`` holds, per checkpoint, the seconds of the host snapshot
    (taken before ``save_async`` returns) and of the write (in the thread).
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self.timings: List[Dict[str, float]] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` now and write it in a thread. In a process group
        every rank calls it (DTensors are gathered) and rank 0 writes."""
        self.wait()
        t0 = time.perf_counter()
        flat = _flatten(tree)  # snapshot now
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        if not _writes():
            return

        def work():
            try:
                t1 = time.perf_counter()
                _write(self.directory, step, flat, extra)
                timing["write_s"] = time.perf_counter() - t1
                self._gc()
            except BaseException as e:  # surfaced in wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
