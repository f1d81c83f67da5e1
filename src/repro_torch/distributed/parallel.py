"""The model's layers on a mesh: the one module that holds the sharding plan
of the model code.

The model code runs as it does on one card until a layer's input is a
DTensor on the ambient mesh (:func:`repro_torch.distributed.hints.active_mesh`);
then it hands the layer to the function of the same name here, with its own
plain computation as ``local``. Each function runs ``local`` on each rank's
local shards (:func:`~repro_torch.distributed.hints.local_region`) with the
plan written down, where DTensor's own plan for a matmul, gather or reshape
would gather or replicate far more than the layer needs:

* ``dense``: Megatron's column and row products, the weight's FSDP shards
  gathered at use;
* ``embed``, ``logits``, ``ce_sum``: the vocabulary over ``model``;
* ``attention``, ``mamba_scan``, ``mlstm``, ``slstm_scan``, ``flip_taps``:
  per batch row and head or channel, where the plain version is exact on a
  shard (DTensor has no rule for the scans, nor for ``flip`` in every torch
  release);
* ``decode_attention``, ``write_slot``: split-K decoding over a cache whose
  batch and sequence dims may be sharded;
* ``moe``: expert parallelism (each rank dispatches the whole batch, runs
  its experts and adds its share).

Each region names its gradients' placements: a replicated input whose work
is split gets a ``Partial`` gradient.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.hints import axis_size, group_sum, local_region, on_mesh
from repro_torch.distributed.sharding import local_shape_offset, mesh_sizes

__all__ = ["dense", "embed", "vocab_split", "logits", "ce_sum", "attention", "mamba_scan",
           "mlstm", "slstm_scan", "flip_taps", "decode_attention", "write_slot", "moe"]


def dense(local: Callable, w: torch.Tensor, x: torch.Tensor, mesh) -> torch.Tensor:
    """``local(w, x)``, the product ``x @ w``, as Megatron's tensor
    parallelism: the weight's FSDP shards (the DP axes) are gathered at use,
    as the reference's rule says, and its ``model`` sharding kept — on the
    output dim (column parallel: the output sharded there), on the input dim
    (row parallel: x split to match, the output a ``Partial`` sum), or none.
    x's rows stay over the DP axes."""
    names = list(mesh_sizes(mesh))
    dp = [a for a in names if a != "model"]
    rows = x.shape[0] % max(1, math.prod(mesh.size(names.index(a)) for a in dp)) == 0
    m_pl = w.placements[names.index("model")] if "model" in names else Replicate()
    col = isinstance(m_pl, Shard) and m_pl.dim == w.ndim - 1
    row = isinstance(m_pl, Shard) and m_pl.dim == w.ndim - 2

    def pl(on_dp, on_model):
        return tuple(on_model if a == "model" else on_dp for a in names)

    batch = Shard(0) if rows else Replicate()
    w_model = Shard(w.ndim - 1) if col else Shard(w.ndim - 2) if row else Replicate()
    x_pl = pl(batch, Shard(x.ndim - 1) if row else Replicate())
    w_pl = pl(Replicate(), w_model)
    out = pl(batch, Shard(x.ndim - 1) if col else Partial() if row else Replicate())
    # each rank's rows feed only its share of the weight's gradient, and a
    # column-parallel rank only its share of x's
    grads = [pl(Partial() if rows else Replicate(), w_model),
             pl(batch, Partial() if col else x_pl[names.index("model")] if row else Replicate())]
    return local_region(local, mesh, [w_pl, x_pl], out, in_grad_specs=grads)(w, x)


def vocab_split(mesh, V: int) -> bool:
    """Whether the vocabulary is sharded over ``model`` (it divides an axis of more than 1)."""
    m = mesh_sizes(mesh).get("model", 1)
    return m > 1 and V % m == 0


def _rows(mesh, n: int) -> tuple:
    """Placements of a tensor whose first dim, of ``n`` rows, goes over the
    DP axes that divide it; replicated over ``model``."""
    return tuple(Shard(0) if a != "model" and n % mesh.size(i) == 0 else Replicate()
                 for i, a in enumerate(mesh_sizes(mesh)))


def _vocab_slice(mesh, V: int):
    """(split, the first row of this rank's vocabulary slice, its rows)."""
    split = vocab_split(mesh, V)
    n = V // mesh.size(list(mesh_sizes(mesh)).index("model")) if split else V
    return split, (mesh.get_local_rank("model") * n if split else 0), n


def embed(table: torch.Tensor, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """``table[tokens]`` on local shards: each ``model`` rank gathers the rows
    of its vocabulary slice (zeros for the others), and the slices are summed
    (``Partial``); the table's FSDP shards are gathered, the tokens' rows
    stay over the DP axes."""
    names = list(mesh_sizes(mesh))
    split, v0, n = _vocab_slice(mesh, table.shape[0])
    rows = _rows(mesh, tokens.shape[0])

    def local(t, tok):
        if not split:  # the whole table on every rank
            return t[tok]
        inside = (tok >= v0) & (tok < v0 + n)
        return t[torch.clamp(tok - v0, 0, n - 1)] * inside[..., None].to(t.dtype)

    w_pl = tuple(Shard(0) if a == "model" and split else Replicate() for a in names)
    out = tuple(Partial() if a == "model" and split else rows[i] for i, a in enumerate(names))
    grad_w = tuple(Partial() if a != "model" else w_pl[i] for i, a in enumerate(names))
    return local_region(local, mesh, [w_pl, rows], out, in_grad_specs=[grad_w, rows])(table, tokens)


def logits(local: Callable, unembed: torch.Tensor, x: torch.Tensor, mesh) -> torch.Tensor:
    """``local(unembed, x)``, the logits product, on local shards: rows over
    the DP axes, the vocabulary over ``model`` (the output sharded there),
    each rank's product the plain one of its slices."""
    names = list(mesh_sizes(mesh))
    split = vocab_split(mesh, unembed.shape[0])
    rows = _rows(mesh, x.shape[0])
    w_pl = tuple(Shard(0) if a == "model" and split else Replicate() for a in names)
    out = tuple(Shard(x.ndim - 1) if a == "model" and split else rows[i]
                for i, a in enumerate(names))
    grads = [tuple(Partial() if a != "model" else w_pl[i] for i, a in enumerate(names)),
             tuple(Partial() if a == "model" and split else rows[i] for i, a in enumerate(names))]
    return local_region(local, mesh, [w_pl, rows], out, in_grad_specs=grads)(unembed, x)


def _vocab_nll(group, v0: int) -> Callable:
    """Each token's ``logsumexp - gold`` from this rank's vocabulary slice
    ``v0 ..`` of the logits: the softmax's max, its sum and the gold logits
    are reduced over ``group`` (the vocab-parallel cross-entropy; each of
    the group's ranks then holds the whole value)."""

    def nll(lg: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        n = lg.shape[-1]
        m = group_sum(torch.amax(lg, dim=-1, keepdim=True).detach(), group, op="max")
        lse = m[..., 0] + torch.log(group_sum(torch.sum(torch.exp(lg - m), dim=-1), group))
        inside = (lab >= v0) & (lab < v0 + n)
        gold = torch.gather(lg, -1, torch.clamp(lab - v0, 0, n - 1)) * inside
        return lse - group_sum(gold[..., 0], group)

    return nll


def ce_sum(local: Callable, unembed: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
           mesh) -> torch.Tensor:
    """``local(unembed, x, labels, nll)``, the summed cross-entropy, on local
    shards: rows over the DP axes, the vocabulary over ``model`` where it
    divides (Megatron's vocab-parallel cross-entropy; ``nll`` None where it
    does not); the result is each DP shard's sum (``Partial``)."""
    names = list(mesh_sizes(mesh))
    dp = [a for a in names if a != "model"]
    split, v0, _ = _vocab_slice(mesh, unembed.shape[0])
    nll = _vocab_nll(mesh.get_group("model"), v0) if split else None

    def pl(per_axis):
        return tuple(per_axis(a) for a in names)

    x_pl = _rows(mesh, x.shape[0])
    w_pl = pl(lambda a: Shard(0) if a == "model" and split else Replicate())
    fn = local_region(
        lambda w, xl, ll: local(w, xl, ll, nll), mesh, [w_pl, x_pl, x_pl],
        pl(lambda a: Partial() if a in dp else Replicate()),
        in_grad_specs=[pl(lambda a: Partial() if a in dp else w_pl[names.index(a)]),
                       pl(lambda a: Partial() if a == "model" and split else x_pl[names.index(a)]),
                       x_pl])
    return fn(unembed, x, labels)


def attention(fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` per batch row and head group, on the local shards
    (heads on ``model`` where the kv heads divide it, as the reference's
    hint puts them)."""
    heads = ("dp", None, "model" if k.shape[2] % axis_size("model") == 0 else None)
    return on_mesh(fn, q, (q, heads), (k, heads), (v, heads), out=heads)(q, k, v)


def mamba_scan(fn: Callable, x, dt, A, B, C, D) -> torch.Tensor:
    """``fn(x, dt, A, B, C, D)`` per batch row and channel, on the local shards."""
    return on_mesh(fn, x, (x, ("dp", None, "model")), (dt, ("dp", None, "model")),
                   (A, ("model", None)), (B, ("dp",)), (C, ("dp",)), (D, ("model",)),
                   out=("dp", None, "model"))(x, dt, A, B, C, D)


def mlstm(fn: Callable, q, k, v, i_gate, f_gate) -> torch.Tensor:
    """``fn(q, k, v, i_gate, f_gate)`` per batch row, on the local shards."""
    return on_mesh(fn, q, (q, ("dp",)), (k, ("dp",)), (v, ("dp",)), (i_gate, ("dp",)),
                   (f_gate, ("dp",)), out=("dp",))(q, k, v, i_gate, f_gate)


def slstm_scan(fn: Callable, R: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """``fn(R, gates)`` per batch row, on the local shards, R whole."""
    return on_mesh(fn, gates, (R, ()), (gates, ("dp",)), out=("dp",))(R, gates)


def flip_taps(w: torch.Tensor, mesh) -> torch.Tensor:
    """``w`` (W, C) reversed along its taps, on each local shard (the taps
    are never sharded)."""
    pl = tuple(w.placements)
    return local_region(lambda t: torch.flip(t, dims=(0,)), mesh, [pl], pl)(w)


def decode_attention(local: Callable, q, k, v, mesh) -> torch.Tensor:
    """``local(q, k, v, offset=, reduce=)``, single-token attention, on local
    shards of a cache whose batch and sequence dims may be sharded (the
    cache's own placements; the heads whole): each rank attends over its
    slots ``offset ..``, and ``reduce(t, op)`` combines the softmax's max,
    its sum and the weighted values over the ranks holding the sequence
    (split-K decoding; None where every rank holds all of it)."""
    names = list(mesh_sizes(mesh))
    groups = [mesh.get_group(names[i]) for i, p in enumerate(k.placements)
              if isinstance(p, Shard) and p.dim == 1 and mesh.size(i) > 1]
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
                  for p in k.placements)
    q_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in kv_pl)
    _, off = local_shape_offset(k.shape, mesh, kv_pl)

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        for grp in groups:
            t = group_sum(t, grp, op=op)
        return t

    def fn(ql, kl, vl):
        return local(ql, kl, vl, offset=off[1], reduce=reduce if groups else None)

    return local_region(fn, mesh, [q_pl, kv_pl, kv_pl], q_pl)(q, k, v)


def write_slot(buf: DTensor, new: torch.Tensor, idx: int) -> None:
    """``buf[:, idx] = new`` in place, for a cache ``buf`` (B, L, H, D) whose
    batch and sequence dims may be sharded: the rank whose shard holds slot
    ``idx`` writes its batch rows of ``new`` (B, H, D) into its local shard,
    and the others write nothing."""
    shape, off = local_shape_offset(buf.shape, buf.device_mesh, buf.placements)
    rows = new.full_tensor() if isinstance(new, DTensor) else new  # a collective: on every rank
    if off[1] <= idx < off[1] + shape[1]:
        buf.to_local()[:, idx - off[1]] = rows[off[0] : off[0] + shape[0]].to(buf.dtype)


def moe(local: Callable, p: dict, x: torch.Tensor, mesh):
    """``local(p, x, e0)``, the MoE layer, on a mesh; ``p``'s expert stacks
    then hold the experts ``e0 ..`` only, or a slice of each expert's FFN
    columns. The tokens and the router are gathered whole (the dispatch is
    global: its capacity counts every token). The expert stacks keep their
    ``model`` sharding: on the expert dim (EP, the reference's
    ``hint(xs, "model")``), or on the FFN dim (the serve rule's fallback
    where E does not divide ``model``); FSDP's ``data`` shards are gathered.
    Each rank computes its experts' (or FFN columns') share of every token's
    output, and the shares are summed over ``model`` (``Partial``)."""
    names = list(mesh_sizes(mesh))
    w = p["w_up"]
    m_dim = names.index("model") if "model" in names else None
    shard = w.placements[m_dim] if m_dim is not None else Replicate()
    ep = isinstance(shard, Shard) and shard.dim == w.ndim - 3
    tp = isinstance(shard, Shard) and shard.dim == w.ndim - 1
    split = ep or tp

    def on_model(dim):  # the stack's "model" sharding kept, its FSDP shards gathered
        return tuple(Shard(dim) if split and n == "model" else Replicate() for n in names)

    expert = {"w_up": on_model(0 if ep else 2), "w_gate": on_model(0 if ep else 2),
              "w_down": on_model(0 if ep else 1)}
    keys = sorted(k for k in p if k in expert)
    whole = tuple(Replicate() for _ in names)  # the tokens and the router, gathered
    # a share of the sum over "model": the output, and the gradients of the
    # tokens and the router; the aux loss is counted once, on model rank 0
    share = tuple(Partial() if split and n == "model" else Replicate() for n in names)
    m_rank = mesh.get_local_rank("model") if split else 0
    e0 = m_rank * (w.shape[-3] // mesh.size(m_dim)) if ep else 0

    def fn(xl, router, *ws):
        out, aux = local({"router": router, **dict(zip(keys, ws, strict=True))}, xl, e0)
        return out, aux if m_rank == 0 else aux * 0.0

    experts = [expert[k] for k in keys]
    run = local_region(fn, mesh, [whole, whole, *experts], [share, share],
                       in_grad_specs=[share, share, *experts])
    return run(x, p["router"], *(p[k] for k in keys))
