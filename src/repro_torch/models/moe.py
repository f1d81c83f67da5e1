"""Mixture-of-Experts MLP: top-k router + capacity-truncated sorted dispatch.

Counterpart of ``repro.models.moe``. Token copies are sorted (stably) by
expert id, truncated to a fixed per-expert capacity
``C = ceil(T*k/E * capacity_factor)``, gathered into an (E, C, d) buffer,
pushed through batched expert matmuls, and combined back with the router
weights. Dispatch is integer work and matches the reference exactly, capacity
drops included. On a mesh the layer runs on local shards with its experts
sharded over ``model`` (:func:`repro_torch.distributed.parallel.moe`), where the reference hints its
expert buffer onto that axis.

The three expert products run through ``ops.gmm`` on the buffer flattened to
(E*C, d) rows sorted by expert, one row block of C rows per expert: on the
card the grouped-matmul kernel K4 (``csrc/gmm.cu``), on the CPU its plain
version. This is the route the reference's docstring names ("on TPU the
batched expert matmul lowers to the Pallas grouped-matmul kernel"), where its
code keeps the einsum equivalent.

While a torch profiler records (:mod:`repro_torch.obs`), the layer opens the
spans ``rt.moe.route`` (router, softmax, top-k, aux loss), ``rt.moe.dispatch``
(sort, capacity, gather), ``rt.moe.experts`` (the expert products) and
``rt.moe.combine`` (the weighted sum of each token's kept copies), and
records the counter ``rt.moe.copies``: the aux loss's per-expert copy counts
and the capacity C, from which the copies kept are sum(min(counts, C)).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.distributed import parallel
from repro_torch.distributed.hints import active_mesh
from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.layers import Params, activation_fn, dense_init, truncated_normal

__all__ = ["moe_init", "moe_apply"]


def moe_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Params:
    mc: MoEConfig = cfg.moe  # type: ignore[assignment]
    d, fe, E = cfg.d_model, mc.d_ff_expert, mc.num_experts
    p: Params = {
        "router": dense_init(gen, d, E, torch.float32, device, lead=lead),
        "w_up": _stack_init(gen, E, d, fe, dtype, device, lead),
        "w_down": _stack_init(gen, E, fe, d, dtype, device, lead),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = _stack_init(gen, E, d, fe, dtype, device, lead)
    return p


def _stack_init(gen, E, din, dout, dtype, device, lead) -> torch.Tensor:
    return truncated_normal(gen, (*lead, E, din, dout), 1.0 / math.sqrt(din), dtype, device)


_GROUP_IDS: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _group_ids(E: int, device: torch.device) -> torch.Tensor:
    """0..E-1 as int32 on ``device``: the group of each row block of C rows.
    Made once per (E, device), not once per layer and step."""
    ids = _GROUP_IDS.get((E, device))
    if ids is None:
        ids = _GROUP_IDS[(E, device)] = torch.arange(E, dtype=torch.int32, device=device)
    return ids


def _expert_ffn(p: Params, xs: torch.Tensor, activation: str, impl: str) -> torch.Tensor:
    """Expert MLP on the (E, C, d) buffer -> its (E*C, d) output rows.

    As in the reference, ``up`` and ``gate`` stay fp32 up to the activation
    (the products' fp32 output); ``h`` and the output are rounded once to the
    input's type.
    """
    E, C, d = xs.shape
    route = ops.resolve_impl(impl, xs)
    group_ids = _group_ids(E, xs.device)
    group_sizes = None if route == "cuda" else [C] * E  # only the plain version reads them

    def product(a: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
        return ops.gmm(a, w, group_ids, group_sizes, impl=route, out_dtype=out_dtype)

    rows = xs.reshape(E * C, d)
    up = product(rows, p["w_up"], torch.float32)
    if activation in ("swiglu", "geglu"):
        gate = product(rows, p["w_gate"], torch.float32)
        act = F.silu if activation == "swiglu" else activation_fn("gelu")
        h = act(gate) * up
    elif activation == "sq_relu":
        h = torch.square(F.relu(up))
    else:
        h = activation_fn("gelu")(up)
    return product(h.to(xs.dtype), p["w_down"])


def moe_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux load-balancing loss (scalar fp32)).

    ``impl`` picks the expert products' route (``ops.gmm``).

    On a mesh (``x`` a DTensor on the ambient mesh) the layer runs on local
    shards (:func:`repro_torch.distributed.parallel.moe`): every rank dispatches the whole batch, as
    the reference's global dispatch does, and runs the experts it holds.
    """
    mesh = active_mesh(x)
    if mesh is not None:
        return parallel.moe(lambda lp, xl, e0: _moe_local(lp, cfg, xl, impl, e0=e0), p, x, mesh)
    return _moe_local(p, cfg, x, impl)


def _moe_local(
    p: Params, cfg: ArchConfig, x: torch.Tensor, impl: str, e0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer on plain tensors. ``p``'s expert stacks may hold the experts
    ``e0 ..`` only, or a slice of each expert's FFN columns: the output is
    then this holder's share of the sum."""
    mc: MoEConfig = cfg.moe  # type: ignore[assignment]
    B, S, d = x.shape
    T = B * S
    E, k = mc.num_experts, mc.top_k
    xt = x.reshape(T, d)
    dev = x.device

    with obs.span("rt.moe.route"):
        logits = torch.matmul(xt.float(), p["router"])  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = torch.topk(probs, k, dim=-1, sorted=True)  # largest first, as lax.top_k
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

        # --- aux loss (Switch-style load balancing) ---------------------
        me = torch.mean(probs, dim=0)  # (E,)
        # the copies per expert (bincount's counts, with a static length:
        # the dry-run traces this with no data)
        flat = top_e.reshape(-1)
        counts = torch.zeros(E, dtype=flat.dtype, device=dev).scatter_add_(
            0, flat, torch.ones_like(flat))
        ce = counts.float() / (T * k)
        aux = torch.sum(me * ce) * E * mc.aux_loss_weight

    # --- sorted, capacity-truncated dispatch ----------------------------
    with obs.span("rt.moe.dispatch"):
        capacity = int(math.ceil(T * k / E * mc.capacity_factor))
        obs.record("rt.moe.copies", counts, capacity)
        flat_e = top_e.reshape(-1)  # (T*k,)
        order = torch.argsort(flat_e, stable=True)  # groups copies by expert, keeps token order
        sorted_e = flat_e[order]
        # position of each copy within its expert group
        pos_in_group = torch.arange(T * k, device=dev) - torch.searchsorted(
            sorted_e, sorted_e, side="left"
        )
        keep = pos_in_group < capacity
        # slot within the (E, C) buffer; dropped copies all go to one trash slot
        slot = torch.where(keep, sorted_e * capacity + pos_in_group, E * capacity)
        src_token = order // k  # token index of each sorted copy

        # gather tokens into expert buffers (+1 trash row, dropped here);
        # kept slots are distinct, so every row but the trash row is written once
        buf_idx = torch.zeros(E * capacity + 1, dtype=torch.long, device=dev)
        buf_idx[slot] = src_token
        xs = xt[buf_idx[: E * capacity]].reshape(E, capacity, d)

    with obs.span("rt.moe.experts"):
        n_local = p["w_up"].shape[-3]
        ys = _expert_ffn(p, xs[e0 : e0 + n_local], cfg.activation, impl)
        if n_local != E:  # expert parallel: the other experts' rows are other ranks' share
            ys = torch.cat([ys.new_zeros((e0 * capacity, d)), ys,
                            ys.new_zeros(((E - e0 - n_local) * capacity, d))])

    # combine: route each kept copy's output back to its token, weighted
    with obs.span("rt.moe.combine"):
        copy_w = top_w.reshape(-1)[order] * keep.float()  # (T*k,)
        copy_out = ys[torch.clamp(slot, max=E * capacity - 1)]
        copy_out = copy_out * copy_w[:, None].to(copy_out.dtype)
        # The reference's ``.at[src_token].add`` adds a token's k copies one
        # at a time in sorted order, rounding after each add. ``index_add_``
        # adds with atomics on CUDA, in an order that changes from run to
        # run, so each token's copies are gathered in sorted order (the
        # inverse of ``order``) and added in turn: the same bits on every run
        # and device.
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * k, device=dev)
        copies = copy_out[torch.sort(inv.reshape(T, k), dim=1).values]  # (T, k, d)
        out = torch.zeros((T, d), dtype=copy_out.dtype, device=dev)
        for i in range(k):
            out = out + copies[:, i]
    return out.reshape(B, S, d).to(x.dtype), aux
