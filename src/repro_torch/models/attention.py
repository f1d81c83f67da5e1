"""GQA attention block: full-sequence (prefill), decode against a KV cache,
and the encoder-decoder's cross-attention.

Counterpart of ``repro.models.attention``; the reference's sharding hints
are dropped (they do nothing on one device).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Params, apply_norm, apply_rope, dense, dense_init, norm_init

__all__ = ["attn_init", "attn_apply", "attn_decode", "init_kv_cache", "cross_attn_init",
           "cross_attn_apply"]


def _proj_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int]
) -> Params:
    """The q, k, v and output projections."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device, lead=lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead=lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device, lead=lead),
    }


def attn_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Params:
    hd = cfg.resolved_head_dim
    p = _proj_init(gen, cfg, dtype, device, lead)
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", dtype, device, lead)
        p["k_norm"] = norm_init(hd, "rmsnorm", dtype, device, lead)
    return p


def _project_qkv(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:  # before rope, as the reference does
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d)
    *,
    window: Optional[int] = None,
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ops.attention(q, k, v, causal=causal, window=window, softcap=None, impl=impl)
    return dense(p["wo"], out.reshape(B, S, -1))


def init_kv_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype, device,
    lead: Sequence[int] = (),
) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor],
    position: int,  # absolute token position (rope)
    write_idx: int,  # cache slot (== position, or position % window for ring-buffer SWA caches)
    fill_len: int,  # number of valid cache slots
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: write k/v at ``write_idx``, attend over valid slots.

    The cache is updated in place (the reference returns a new one) and
    returned. Sliding-window layers size their cache to the window and
    overwrite slots modularly (ring buffer): attention is permutation-invariant
    over keys and rope is applied at absolute positions before the write, so no
    window mask is needed — eviction is the mask.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), position, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    cache["k"][:, write_idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_idx] = v[:, 0].to(cache["v"].dtype)
    out = _decode_attention(q, cache["k"], cache["v"], fill_len)
    return dense(p["wo"], out.reshape(B, 1, -1)), cache


def _decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, L, Hkv, D)
    v: torch.Tensor,
    fill_len: int,
) -> torch.Tensor:
    """Single-token attention against a cache, in plain torch ops (fp32).

    The reference has no Pallas kernel here either; it is bound by reading
    the cache.
    """
    B, L, Hkv, D = k.shape
    Hq = q.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, 1, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    ok = torch.arange(L, device=q.device) < fill_len
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ------------------------- cross attention (enc-dec) -----------------------


def cross_attn_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Params:
    """The reference's cross-attention projections: no qk-norm."""
    return _proj_init(gen, cfg, dtype, device, lead)


def cross_attn_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, d) decoder states
    enc: torch.Tensor,  # (B, T, d) encoder output
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """q from the decoder states, k and v from the encoder output; no rope and
    no qk-norm, every key seen (``causal=False``), as the reference does. On
    the card this is flash attention with Sq = S against Sk = T (S = 1 in a
    decode step)."""
    B, S, _ = x.shape
    T = enc.shape[1]
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], enc).reshape(B, T, cfg.n_kv_heads, hd)
    v = dense(p["wv"], enc).reshape(B, T, cfg.n_kv_heads, hd)
    out = ops.attention(q, k, v, causal=False, window=None, impl=impl)
    return dense(p["wo"], out.reshape(B, S, -1))
