"""Sharding rules: FSDP x TP 2-D parameter sharding, EP for MoE, SP for
long-context decode (counterpart of ``repro.distributed.sharding``).

Mesh axes:
* ``data``  — batch / FSDP axis (16 per pod),
* ``model`` — tensor-parallel / expert-parallel / sequence axis (16 per pod),
* ``pod``   — present on the multi-pod mesh; pure data parallelism
              (parameters replicated across pods, gradients reduced over it).

Parameter rule: 2-D weights are sharded (contract-dim -> ``data`` [FSDP,
gathered at use], parallel-dim -> ``model`` [Megatron TP, stays sharded]).
Expert stacks put the expert dim on ``model`` (EP). Rules are resolved by
leaf *name* via tree paths, so one table covers every architecture.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry per
tensor dimension, each ``None``, an axis name or a tuple of axis names.
The rule functions read only the mesh's axis names and sizes, so they take
a ``DeviceMesh`` or a mapping ``{"data": 16, "model": 16}`` alike and need
no process group. :func:`placements` turns a spec into DTensor placements
(one per mesh dimension), and :func:`distribute_tree` / :func:`full_tree`
move a tree onto and off the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.tree import flatten_with_paths, unflatten

__all__ = [
    "DP_AXES",
    "param_spec",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "out_shardings_like",
    "placements",
    "distribute_tree",
    "full_tree",
    "mesh_sizes",
    "local_shape_offset",
    "spec_leaves",
]

Spec = Tuple[Any, ...]

# batch ("data-parallel") axes: pod axis, when present, is outermost DP
DP_AXES = ("pod", "data")


def mesh_sizes(mesh: Union[Mapping[str, int], Any]) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def _size(sizes: Dict[str, int], ax: Any) -> int:
    n = 1
    for a in ax if isinstance(ax, tuple) else (ax,):
        n *= sizes[a]
    return n


def _dp(sizes: Dict[str, int]) -> Any:
    axes = tuple(a for a in DP_AXES if a in sizes)
    return axes if len(axes) > 1 else axes[0]


def _names(path: Sequence[Any]) -> list:
    return [str(k) for k in path]


# --------------------------- parameter rules -------------------------------

# leaf name -> spec template for the UNSTACKED (per-layer) array.
# "D" = data axis, "M" = model axis, None = replicated dim.
_RULES = {
    # projections: (in, out)
    "wq": ("D", "M"),
    "wk": ("D", "M"),
    "wv": ("D", "M"),
    "wo": ("M", "D"),
    "w_up": ("D", "M"),
    "w_gate": ("D", "M"),
    "w_down": ("M", "D"),
    "w_ffn_up": ("D", "M"),
    "w_ffn_down": ("M", "D"),
    "w_in": ("D", "M"),
    "w_out": ("M", "D"),
    "w_xdbc": ("M", None),
    "w_dt": (None, "M"),
    "w_i": ("M", None),
    "w_f": ("M", None),
    "w_z": ("D", "M"),
    "w_o": ("D", "M"),
    # embeddings: (vocab/time, d_model)
    "embed": ("M", "D"),
    "unembed": ("M", "D"),
    "pos": (None, "D"),
    # misc
    "router": ("D", None),
    "conv": (None, "M"),
    "log_a": ("M", None),
    "dt_bias": ("M",),
    "d_skip": ("M",),
    "scale": (None,),
    "bias": (None,),
    # sLSTM recurrent blocks (small, head-blocked)
    "r_i": (None, None, None),
    "r_f": (None, None, None),
    "r_z": (None, None, None),
    "r_o": (None, None, None),
}

# MoE expert stacks carry a leading expert dim -> model axis (EP); the
# per-expert matrices are then FSDP-sharded on their d_model dim.
_MOE_RULES = {
    "w_up": ("M", "D", None),
    "w_gate": ("M", "D", None),
    "w_down": ("M", None, "D"),
}


def _axis(token: Optional[str]) -> Optional[str]:
    return {"D": "data", "M": "model", None: None}[token]


def param_spec(path: Sequence[Any], leaf: Any) -> Spec:
    """The spec of one parameter leaf, from its tree path."""
    names = _names(path)
    leaf_name = names[-1]
    in_moe = "moe" in names
    in_blocks = "blocks" in names

    if in_moe and leaf_name in _MOE_RULES:
        base = _MOE_RULES[leaf_name]
    elif leaf_name in _RULES:
        base = _RULES[leaf_name]
    else:
        base = (None,) * (leaf.ndim - (2 if in_blocks else 0) - ("layers" in names))

    spec = [_axis(t) for t in base]
    # stacked leading axes: pattern repeats (blocks) / encoder layer stack
    ndim = leaf.ndim
    while len(spec) < ndim:
        spec.insert(0, None)
    if len(spec) > ndim:  # e.g. rules longer than a squeezed leaf
        spec = spec[-ndim:]
    return tuple(spec)


def _validated(spec: Spec, shape: Tuple[int, ...], sizes: Dict[str, int]) -> Spec:
    """Drop every axis that does not divide its dimension evenly."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec)), strict=False):
        if ax is None:
            out.append(None)
            continue
        out.append(ax if dim % _size(sizes, ax) == 0 else None)
    return tuple(out)


def param_shardings(params: Any, mesh: Any, mode: str = "train") -> Any:
    """A spec tree matching a parameter (or meta-parameter) tree.

    ``mode="serve"``: inference keeps weights *resident* — the FSDP ("data")
    dimension is dropped from every spec (pure TP/EP) whenever the resulting
    per-device footprint fits in 8 GiB. Models too big for 1-axis sharding
    (nemotron-340b) keep the 2-D layout. Where an expert stack's E does not
    divide the ``model`` axis, its FFN dims take ``model`` instead (TP).
    """
    sizes = mesh_sizes(mesh)
    flat = flatten_with_paths(params)
    serve = mode == "serve"
    if serve:
        total_bytes = sum(leaf.numel() * leaf.dtype.itemsize for _, leaf in flat)
        # would pure model-axis sharding fit comfortably (<= half of HBM)?
        per_dev = total_bytes / sizes["model"]
        serve = per_dev <= 8 * 1024**3

    def mk(path, leaf):
        spec = param_spec(path, leaf)
        if serve:
            spec = tuple(None if ax == "data" else ax for ax in spec)
            names = _names(path)
            leaf_name = names[-1]
            if "moe" in names and leaf_name in _MOE_RULES:
                E = leaf.shape[-3] if leaf.ndim >= 3 else 0
                if E % sizes["model"] != 0:
                    # EP impossible (E < axis): TP-shard the expert FFN dims
                    # (contraction-dim psum at decode is tokens-sized, tiny)
                    base = ((None, None, "model") if leaf_name in ("w_up", "w_gate")
                            else (None, "model", None))
                    spec = (*([None] * (leaf.ndim - 3)), *base)
        return _validated(spec, tuple(leaf.shape), sizes)

    return unflatten(params, [mk(path, leaf) for path, leaf in flat])


# --------------------------- activations -----------------------------------


def batch_shardings(batch: Any, mesh: Any) -> Any:
    """Input batch: leading (batch) dim over the DP axes, rest replicated."""
    sizes = mesh_sizes(mesh)
    dp = _dp(sizes)
    dims = _size(sizes, dp)

    def mk(leaf):
        first = dp if leaf.shape and leaf.shape[0] % dims == 0 else None
        return (first, *([None] * (leaf.ndim - 1)))

    return unflatten(batch, [mk(leaf) for _, leaf in flatten_with_paths(batch)])


def cache_shardings(cache: Any, mesh: Any, batch: int) -> Any:
    """Decode-state sharding.

    KV caches (stacked: (R, B, L, H, D)) shard batch over the DP axes when it
    divides evenly; the sequence dim takes the ``model`` axis (SP — the 32k
    KV cache is the dominant decode footprint) and, for batch=1 long-context,
    whatever DP axes are idle join the sequence dim.
    Recurrent states (mamba/xlstm) shard their channel dims on ``model``.
    """
    sizes = mesh_sizes(mesh)
    dp = _dp(sizes)
    dp_size = _size(sizes, dp)

    def mk(path, leaf):
        leaf_name = _names(path)[-1]
        if leaf_name in ("k", "v") and leaf.ndim == 5:  # (R, B, L, H, D)
            _, B, L, H, D = leaf.shape
            if B % dp_size == 0:
                seq_ax = "model" if L % sizes["model"] == 0 else None
                return (None, dp, seq_ax, None, None)
            # tiny batch (long-context): give the sequence every axis we can
            seq_axes = tuple(a for a in ("data", "model") if L % sizes[a] == 0)
            if len(seq_axes) == 2 and L % (sizes["data"] * sizes["model"]) != 0:
                seq_axes = ("model",)
            spec = seq_axes if len(seq_axes) > 1 else (seq_axes[0] if seq_axes else None)
            return (None, None, spec, None, None)
        if leaf_name in ("h", "C") and leaf.ndim >= 3:  # recurrent states
            B = leaf.shape[1]
            bspec = dp if B % dp_size == 0 else None
            rest = [None] * (leaf.ndim - 2)
            if leaf.shape[2] % sizes["model"] == 0:
                rest[0] = "model"
            return (None, bspec, *rest)
        # conv windows / norm stats / small states
        B = leaf.shape[1] if leaf.ndim > 1 else 0
        bspec = dp if B and B % dp_size == 0 else None
        return (None, bspec, *([None] * max(leaf.ndim - 2, 0)))

    return unflatten(cache, [mk(path, leaf) for path, leaf in flatten_with_paths(cache)])


def out_shardings_like(tree: Any, mesh: Any) -> Any:
    """Replicated output specs for scalars/metrics."""
    return unflatten(tree, [() for _ in flatten_with_paths(tree)])


# --------------------------- DTensor placement ------------------------------


def placements(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements of ``spec``: per mesh dimension, ``Shard(d)`` for
    the tensor dimension ``d`` whose entry names it, else ``Replicate()``.
    A dimension over two axes (``("pod", "data")``) is sharded on both mesh
    dimensions, outer first, as the reference's tuple entry is."""
    owner: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh_sizes(mesh))


def local_shape_offset(shape: Sequence[int], mesh: Any, pl: Sequence[Any]) -> Tuple[list, list]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` under placements ``pl`` (even sharding: the rules keep only
    axes that divide), in plain integers."""
    local, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[i]
            off[p.dim] += coord[i] * local[p.dim]
    return local, off


def distribute_tree(tree: Any, shardings: Any, mesh: Any) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` with the specs of
    ``shardings`` (a tree of the same structure). Every rank passes the full
    tensors, as ``distribute_tensor`` asks; a DTensor leaf is redistributed."""
    specs = spec_leaves(shardings)
    out = []
    for (_, leaf), spec in zip(flatten_with_paths(tree), specs, strict=True):
        pl = placements(spec, mesh)
        if isinstance(leaf, DTensor):
            out.append(leaf.redistribute(mesh, pl))
        else:
            out.append(distribute_tensor(leaf, mesh, pl))
    return unflatten(tree, out)


def spec_leaves(shardings: Any) -> list:
    """The specs of a spec tree in the leaf order of the tree it describes:
    a plain tuple of axis entries is a leaf; dicts, lists and NamedTuples
    (an ``OptState`` of spec trees) are containers."""
    if isinstance(shardings, dict):
        return [s for k in sorted(shardings) for s in spec_leaves(shardings[k])]
    if isinstance(shardings, list) or hasattr(shardings, "_fields"):
        return [s for child in shardings for s in spec_leaves(child)]
    return [shardings]


def full_tree(tree: Any) -> Any:
    """``tree`` with every DTensor gathered to its full tensor (plain tensors kept)."""
    return unflatten(tree, [leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
                            for _, leaf in flatten_with_paths(tree)])
