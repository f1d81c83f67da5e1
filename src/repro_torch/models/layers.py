"""Primitive layers: norms, rotary embeddings, MLP variants, embeddings.

Counterpart of ``repro.models.layers``. Parameters are nested dicts of
tensors with the JAX package's key paths; every function takes (params,
inputs) and returns outputs. Initialisers draw from an explicit
``torch.Generator`` with the reference's distributions (not its numbers:
``jax.random`` and ``torch.Generator`` give different streams).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed import parallel
from repro_torch.distributed.hints import active_mesh

__all__ = [
    "Params",
    "truncated_normal",
    "dense_init",
    "dense",
    "norm_init",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "mlp_init",
    "mlp_apply",
    "embed_init",
    "activation_fn",
]

Params = Dict[str, Any]


# numbers drawn at a time by ``truncated_normal``: 1 GiB of fp32
DRAW_CHUNK = 1 << 28


def truncated_normal(
    gen: torch.Generator, shape: Sequence[int], scale: float, dtype: torch.dtype, device
) -> torch.Tensor:
    """Normal(0, 1) truncated to [-2, 2], times ``scale``, drawn in fp32.

    A leaf of more than ``DRAW_CHUNK`` numbers is drawn ``DRAW_CHUNK`` at a
    time into its own storage, so a full-width leaf (nemotron-4-340b's
    embedding, 4.7 G numbers; a 6-layer stack of its ``w_up``, 8.2 G) holds
    one 1 GiB fp32 draw beside it at most, not an fp32 copy of itself. A
    smaller leaf is one draw, as before."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_CHUNK):
        x = torch.empty(min(DRAW_CHUNK, flat.numel() - i), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[i : i + x.numel()] = x.mul_(scale)
    return out


def dense_init(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    dtype: torch.dtype,
    device,
    lead: Sequence[int] = (),
) -> torch.Tensor:
    """``(*lead, in_dim, out_dim)`` weights with std ``1/sqrt(in_dim)``; ``lead`` is
    the stacked-repeat axis."""
    return truncated_normal(gen, (*lead, in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype, device)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, cast to ``x.dtype``.

    A bf16 matmul accumulates in fp32 and rounds once at the end on both the
    CPU and the card (``resolve_device`` turns off cuBLAS's reduced-precision
    bf16 reduction), which is the reference's ``preferred_element_type=fp32``
    followed by ``astype(x.dtype)``.
    """
    mesh = active_mesh(w)
    if mesh is not None:  # Megatron's tensor parallelism on local shards
        return parallel.dense(dense, w, x, mesh)
    return torch.matmul(x, w.to(x.dtype)).to(x.dtype)


# ----------------------------- norms ------------------------------------


def norm_init(d: int, kind: str, dtype: torch.dtype, device, lead: Sequence[int] = ()) -> Params:
    p: Params = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm/LayerNorm in fp32; RMSNorm multiplies by ``scale`` (not ``1 + scale``)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(x.dtype)
    if kind == "layernorm":
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    raise ValueError(f"unknown norm kind {kind!r}")


# ----------------------------- rotary ------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(
    x: torch.Tensor,  # (..., seq, heads, head_dim)
    positions: torch.Tensor,  # (..., seq) absolute positions
    theta: float,
) -> torch.Tensor:
    """Split-half (not interleaved) rotary embedding, computed in fp32."""
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------- MLPs --------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "gelu":
        return _gelu
    if name == "sq_relu":  # nemotron squared-ReLU
        return lambda x: torch.square(F.relu(x))
    if name == "silu":
        return F.silu
    raise ValueError(f"not a plain activation: {name!r}")


def mlp_init(
    gen: torch.Generator, d: int, f: int, activation: str, dtype: torch.dtype, device,
    lead: Sequence[int] = (),
) -> Params:
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, f, dtype, device, lead=lead),
            "w_up": dense_init(gen, d, f, dtype, device, lead=lead),
            "w_down": dense_init(gen, f, d, dtype, device, lead=lead),
        }
    return {
        "w_up": dense_init(gen, d, f, dtype, device, lead=lead),
        "w_down": dense_init(gen, f, d, dtype, device, lead=lead),
    }


def mlp_apply(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return dense(p["w_down"], F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    if activation == "geglu":
        return dense(p["w_down"], _gelu(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    act = activation_fn(activation)
    return dense(p["w_down"], act(dense(p["w_up"], x)))


# ----------------------------- embeddings --------------------------------


def embed_init(
    gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype, device
) -> torch.Tensor:
    return truncated_normal(gen, (vocab, d), 1.0, dtype, device)
