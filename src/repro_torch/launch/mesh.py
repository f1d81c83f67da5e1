"""Mesh construction (counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world
that ``torch.distributed`` has: a real NCCL or gloo world, or the ``fake``
backend for the dry-run (:mod:`repro_torch.launch.dryrun`). Meshes are built
in FUNCTIONS, never at import: importing this module starts no process group
and touches no device, as the reference keeps its module free of jax device
state.

``set_ambient_mesh`` (kept in :mod:`repro_torch.distributed.hints`, which
the model code reads, and exported here as the reference exports it) stands
in for JAX's abstract mesh. With none set, every hint is a no-op and the
models run as they do on one card.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike
from repro_torch.distributed.hints import get_ambient_mesh, set_ambient_mesh

__all__ = ["make_production_mesh", "make_smoke_mesh", "set_ambient_mesh", "get_ambient_mesh",
           "entry_mesh", "POD_SHAPE"]

POD_SHAPE = (16, 16)  # the reference's production pod: 256 devices as (data, model)

def _device_type(device: DeviceLike) -> str:
    """``"cuda"`` unless the caller asks for ``"cpu"``."""
    kind = "cuda" if device is None else str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device!r}: use 'cuda' or 'cpu'")
    return kind


def _world_size() -> int:
    """The ranks of the default process group; 1 (this process) without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """The production mesh: (16, 16) as ("data", "model"), or (2, 16, 16) as
    ("pod", "data", "model") with ``multi_pod``. The world must have exactly
    that many ranks."""
    shape = (2, *POD_SHAPE) if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = _world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of {need} ranks; "
                         f"this one has {world}")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def smoke_mesh_shape(n: int, data: Optional[int] = None,
                     model: Optional[int] = None) -> tuple:
    """(data, model) of the smoke mesh over ``n`` ranks, split as the
    reference splits ``jax.device_count()``: halve ``data`` onto ``model``
    while ``data`` is even and ``model < data``."""
    if data is None or model is None:
        model = 1
        data = n
        while data % 2 == 0 and model < data:
            data //= 2
            model *= 2
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; the world has {n}")
    return data, model


def make_smoke_mesh(data: Optional[int] = None, model: Optional[int] = None,
                    device: DeviceLike = None) -> DeviceMesh:
    """A small ("data", "model") mesh over the whole world (tests, one card)."""
    shape = smoke_mesh_shape(_world_size(), data, model)
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=("data", "model"))


def entry_mesh(production_mesh: bool, device: DeviceLike = None) -> Optional[DeviceMesh]:
    """The mesh of an entry point (``train``, ``serve``), set as the ambient
    mesh: the production mesh if asked for, else the smoke mesh over the
    process group; None with no process group (one device, no mesh)."""
    if production_mesh:
        mesh = make_production_mesh(device=device)
    elif dist.is_initialized():
        mesh = make_smoke_mesh(device=device)
    else:
        return None
    set_ambient_mesh(mesh)
    return mesh
