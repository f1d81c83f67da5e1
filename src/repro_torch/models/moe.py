"""Mixture-of-Experts MLP: top-k router + capacity-truncated sorted dispatch.

Counterpart of ``repro.models.moe``. Token copies are sorted (stably) by
expert id, truncated to a fixed per-expert capacity
``C = ceil(T*k/E * capacity_factor)``, gathered into an (E, C, d) buffer,
pushed through batched expert matmuls, and combined back with the router
weights. Dispatch is integer work and matches the reference exactly, capacity
drops included. The reference's sharding hint on the expert axis does nothing
on one card and is dropped.

The expert matmuls are plain batched products (``torch.bmm``), as they are
einsums outside any Pallas kernel in the reference; the grouped-matmul kernel
K4 is a later slice's ``impl`` choice (ROADMAP.md A.4).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32, without an fp32 copy of ``b``
    on the card (the reference's ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())  # the fp32-output bmm has no CPU kernel


def _expert_ffn(p: Params, xs: torch.Tensor, activation: str) -> torch.Tensor:
    """Batched expert MLP: xs (E, C, d) -> (E, C, d).

    As in the reference, ``up`` and ``gate`` stay fp32 up to the activation;
    ``h`` and the output are rounded once to the input's type.
    """
    up = _bmm_f32(xs, p["w_up"])
    if activation in ("swiglu", "geglu"):
        gate = _bmm_f32(xs, p["w_gate"])
        act = F.silu if activation == "swiglu" else activation_fn("gelu")
        h = act(gate) * up
    elif activation == "sq_relu":
        h = torch.square(F.relu(up))
    else:
        h = activation_fn("gelu")(up)
    return torch.bmm(h.to(xs.dtype), p["w_down"]).to(xs.dtype)


def moe_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux load-balancing loss (scalar fp32))."""
    mc: MoEConfig = cfg.moe  # type: ignore[assignment]
    B, S, d = x.shape
    T = B * S
    E, k = mc.num_experts, mc.top_k
    xt = x.reshape(T, d)
    dev = x.device

    logits = torch.matmul(xt.float(), p["router"])  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1, sorted=True)  # largest first, as lax.top_k
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # --- aux loss (Switch-style load balancing) -------------------------
    me = torch.mean(probs, dim=0)  # (E,)
    ce = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * k)
    aux = torch.sum(me * ce) * E * mc.aux_loss_weight

    # --- sorted, capacity-truncated dispatch ----------------------------
    capacity = int(math.ceil(T * k / E * mc.capacity_factor))
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

    # gather tokens into expert buffers (+1 trash row, dropped here); kept
    # slots are distinct, so every row but the trash row is written once
    buf_idx = torch.zeros(E * capacity + 1, dtype=torch.long, device=dev)
    buf_idx[slot] = src_token
    xs = xt[buf_idx[: E * capacity]].reshape(E, capacity, d)

    ys = _expert_ffn(p, xs, cfg.activation).reshape(E * capacity, d)

    # combine: route each kept copy's output back to its token, weighted
    copy_w = top_w.reshape(-1)[order] * keep.float()  # (T*k,)
    copy_out = ys[torch.clamp(slot, max=E * capacity - 1)]
    copy_out = copy_out * copy_w[:, None].to(copy_out.dtype)
    out = torch.zeros((T, d), dtype=copy_out.dtype, device=dev).index_add_(0, src_token, copy_out)
    return out.reshape(B, S, d).to(x.dtype), aux
