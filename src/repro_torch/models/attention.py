"""GQA attention block: full-sequence (prefill), decode against a KV cache,
and the encoder-decoder's cross-attention.

Counterpart of ``repro.models.attention``. The q, k and v projections carry
the reference's sharding hints (heads on ``model``), which do nothing without
a mesh.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import parallel
from repro_torch.distributed.hints import active_mesh, axis_size, hint
from repro_torch.kernels import ops, ref
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


def _heads(y: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, H * hd) -> (B, S, H, hd). On a mesh the heads go on ``model``
    (the reference's hint); where H does not divide that axis, the flat dim
    is first gathered whole, as the split cannot cut a head."""
    B, S, F = y.shape
    y = hint(y, "dp", None, "model" if H % axis_size("model") == 0 else None)
    return hint(y.reshape(B, S, H, F // H), "dp", None, "model", None)


def _project_qkv(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = _heads(dense(p["wq"], x), cfg.n_heads)
    k = _heads(dense(p["wk"], x), cfg.n_kv_heads)
    v = _heads(dense(p["wv"], x), cfg.n_kv_heads)
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
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: write k/v at ``write_idx``, attend over valid slots.

    The cache is updated in place (the reference returns a new one) and
    returned. Sliding-window layers size their cache to the window and
    overwrite slots modularly (ring buffer): attention is permutation-invariant
    over keys and rope is applied at absolute positions before the write, so no
    window mask is needed — eviction is the mask. ``impl`` is the route of the
    attention over the cache (``ops.decode_attention``: on the card, K5).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), position, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    _write_slot(cache["k"], k[:, 0], write_idx)
    _write_slot(cache["v"], v[:, 0], write_idx)
    out = _decode_attention(q, cache["k"], cache["v"], fill_len, impl)
    return dense(p["wo"], out.reshape(B, 1, -1)), cache


def _write_slot(buf: torch.Tensor, new: torch.Tensor, idx: int) -> None:
    """``buf[:, idx] = new`` in place (buf (B, L, H, D), new (B, H, D)); a
    cache on a mesh through :func:`repro_torch.distributed.parallel.write_slot`."""
    if isinstance(buf, DTensor):
        parallel.write_slot(buf, new, idx)
    else:
        buf[:, idx] = new.to(buf.dtype)


def _decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, L, Hkv, D)
    v: torch.Tensor,
    fill_len: int,
    impl: str,
) -> torch.Tensor:
    """Single-token attention against a cache: ``ops.decode_attention`` (K5 on
    the card, the plain version on the CPU or at ``impl="ref"``). A cache on a
    mesh (:func:`repro_torch.distributed.parallel.decode_attention`) takes the
    plain split-K path of :func:`_decode_attention_local` on each rank's
    slots, whatever ``impl``."""
    mesh = active_mesh(k)
    if mesh is not None:
        return parallel.decode_attention(functools.partial(_decode_attention_local, fill_len=fill_len),
                                         q, k, v, mesh)
    return ops.decode_attention(q, k, v, fill_len, impl=impl)


def _decode_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    fill_len: int,
    offset: int,
    reduce: Optional[Callable],
) -> torch.Tensor:
    """One rank's part on a mesh, in plain torch ops (fp32): k and v hold the
    slots ``offset ..`` of a cache whose sequence may be split over ranks, and
    ``reduce(t, op)`` combines the softmax's max, its sum and the weighted
    values over them (split-K decoding); None where the rank holds every slot
    (``offset`` 0)."""
    if reduce is None:
        return ref.decode_attention_ref(q, k, v, fill_len)
    B, _, Hkv, D = k.shape
    scores = ref.decode_scores(q, k, fill_len, offset)
    m = reduce(torch.amax(scores, dim=-1, keepdim=True), "max")
    p = torch.exp(scores - m)
    den = reduce(torch.sum(p, dim=-1, keepdim=True), "sum")
    out = reduce(torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()), "sum")
    out = out / den[..., 0].permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, 1, q.shape[2], D).to(q.dtype)


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
    q = _heads(dense(p["wq"], x), cfg.n_heads)
    k = _heads(dense(p["wk"], enc), cfg.n_kv_heads)
    v = _heads(dense(p["wv"], enc), cfg.n_kv_heads)
    out = ops.attention(q, k, v, causal=False, window=None, impl=impl)
    return dense(p["wo"], out.reshape(B, S, -1))
