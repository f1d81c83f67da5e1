"""Best-effort sharding hints usable from model code (``repro.distributed.hints``).

``hint(x, *axes)`` redistributes a DTensor ``x`` to the placements of the
requested logical axes when (a) an ambient mesh is set
(:func:`set_ambient_mesh`, JAX's abstract mesh), (b) ``x`` is a DTensor
on it — otherwise it is a no-op. An axis the mesh lacks, or whose size does
not divide its dimension, becomes ``None``; missing trailing axes are
``None``, as the reference's docstring promises (its ``zip(..., strict=True)``
raises instead for fewer axes than dimensions, e.g. ``hint(xs, "model")`` on
the MoE's 3-D buffer; the port follows the intent).

Axis tokens: "dp" (all data-parallel axes: pod+data), "data", "model", None.

:func:`local_region` runs a function the DTensor layer has no rules for
(``bincount``, the sequential scans) on each rank's local shards, with its
inputs redistributed to the given specs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import mesh_sizes, placements

__all__ = ["hint", "hint_spec", "local_region", "on_mesh", "active_mesh", "axis_size",
           "group_sum", "set_ambient_mesh", "get_ambient_mesh"]

_AMBIENT: Optional[DeviceMesh] = None


def set_ambient_mesh(mesh: Optional[DeviceMesh]) -> None:
    """The mesh the model code's hints read (``None`` clears it)."""
    global _AMBIENT
    _AMBIENT = mesh


def get_ambient_mesh() -> Optional[DeviceMesh]:
    return _AMBIENT


def active_mesh(x: Any):
    """The ambient mesh if ``x`` is a DTensor on it, else None."""
    mesh = get_ambient_mesh()
    if mesh is None or not isinstance(x, DTensor) or x.device_mesh != mesh:
        return None
    return mesh


def hint_spec(shape: Sequence[int], axes: Sequence[Any], sizes: dict) -> tuple:
    """The spec ``hint`` pins for a tensor of ``shape`` on a mesh of ``sizes``."""
    names = tuple(sizes)
    spec = []
    for dim, ax in zip(shape, axes, strict=False):
        if ax == "dp":
            cand = tuple(a for a in ("pod", "data") if a in names)
            ax = cand if len(cand) > 1 else (cand[0] if cand else None)
        if ax is None:
            spec.append(None)
            continue
        ax_t = ax if isinstance(ax, tuple) else (ax,)
        if not all(a in names for a in ax_t):
            spec.append(None)
            continue
        size = 1
        for a in ax_t:
            size *= sizes[a]
        spec.append(ax if dim % max(size, 1) == 0 else None)
    spec += [None] * (len(shape) - len(spec))
    return tuple(spec)


def axis_size(name: str) -> int:
    """The ambient mesh's size along ``name`` (1 with no mesh or no such axis)."""
    mesh = get_ambient_mesh()
    return mesh_sizes(mesh).get(name, 1) if mesh is not None else 1


def hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain tensor dims to mesh axes; a no-op with no mesh or a plain tensor."""
    mesh = active_mesh(x)
    if mesh is None:
        return x
    pl = placements(hint_spec(x.shape, axes, mesh_sizes(mesh)), mesh)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


class _GroupSum(torch.autograd.Function):
    """A sum (or max) over a process group whose every member then uses the
    whole result: the backward passes each member's gradient through as it
    is (Megatron's "g" operator)."""

    @staticmethod
    def forward(ctx, x, group, op):
        return funcol.wait_tensor(funcol.all_reduce(x, op, group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def group_sum(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (``op`` "sum" or "max"), for code on local shards."""
    return _GroupSum.apply(x, group, op)


def local_region(fn: Callable, mesh, in_specs: Sequence[Any], out_specs: Any,
                 in_grad_specs: Optional[Sequence[Any]] = None):
    """``fn`` run on local shards: each DTensor argument is first
    redistributed to its placements in ``in_specs`` (one per mesh dimension,
    ``None`` for a non-tensor argument), and the output is wrapped as a
    DTensor with ``out_specs``: placements for a single output, a list of
    them for several. ``in_grad_specs`` gives the placements of the local
    gradients where they differ from the inputs' (a ``Partial`` where each
    rank's share of the work feeds only its share of an input's gradient).
    Every sharded dimension must divide evenly."""
    outs = tuple(out_specs) if isinstance(out_specs, list) else list(out_specs)
    return local_map(fn, out_placements=outs, in_placements=tuple(in_specs),
                     in_grad_placements=None if in_grad_specs is None else tuple(in_grad_specs),
                     device_mesh=mesh, redistribute_inputs=True)


def on_mesh(fn: Callable, lead: torch.Tensor, *args, out: Sequence[Any]) -> Optional[Callable]:
    """``fn`` as a :func:`local_region` if ``lead`` is a DTensor on the ambient
    mesh, else None. ``args`` are ``(tensor, axes)`` pairs in ``fn``'s
    argument order, with hint axis tokens; the output's spec is ``out``'s
    tokens at ``lead``'s shape. An input not sharded over a mesh axis that
    the output is sharded over gets a ``Partial`` gradient there: each rank
    adds only its rows' or channels' share to it."""
    mesh = active_mesh(lead)
    if mesh is None:
        return None
    sizes = mesh_sizes(mesh)
    in_pl = [placements(hint_spec(t.shape, axes, sizes), mesh) for t, axes in args]
    out_pl = placements(hint_spec(lead.shape, out, sizes), mesh)
    sharded = {a for a, p in zip(sizes, out_pl, strict=True) if not isinstance(p, Replicate)}

    def grad(pl):
        return tuple(Partial() if isinstance(p, Replicate) and a in sharded else p
                     for a, p in zip(sizes, pl, strict=True))

    return local_region(fn, mesh, in_pl, out_pl, in_grad_specs=[grad(pl) for pl in in_pl])
