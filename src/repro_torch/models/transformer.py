"""Block-pattern model builder (counterpart of ``repro.models.transformer``).

The layer stack is grouped into the architecture's repeating *pattern unit*
with the parameters of each unit position stacked over repeats, exactly as in
the JAX package, so parameter trees convert one to one
(:mod:`repro_torch.models.convert`). Where the reference scans the repeats,
this runs a plain loop over them.

Ported layer kinds: ATTN and LOCAL_ATTN with a dense MLP. The others raise
``NotImplementedError`` naming their ROADMAP.md item.

Entry points:
* :func:`init_params`  — random parameters from a seeded ``torch.Generator``
* :func:`forward`      — full-sequence (prefill / scoring) -> logits, aux
* :func:`init_cache`   — per-layer KV cache, stacked like the params
* :func:`decode_step`  — one token against the cache (updated in place)

Each takes ``device=None``: the card unless the caller passes ``"cpu"``
(:func:`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attn_apply, attn_decode, attn_init, init_kv_cache
from repro_torch.models.config import ArchConfig, LayerKind
from repro_torch.models.layers import Params, apply_norm, embed_init, mlp_apply, mlp_init, norm_init

__all__ = [
    "init_params",
    "abstract_params",
    "forward",
    "init_cache",
    "decode_step",
    "apply_unit",
]

# layer kinds and features that wait for a later slice, by ROADMAP.md item
_UNPORTED_KINDS = {
    LayerKind.MAMBA: "A.2 (jamba: mamba mixer and the mamba_scan kernel, K2)",
    LayerKind.MLSTM: "A.3 (xlstm: mLSTM block and the mlstm kernel, K3)",
    LayerKind.SLSTM: "A.3 (xlstm: sLSTM block)",
}


def _check_ported(cfg: ArchConfig) -> None:
    for kind, is_moe in cfg.pattern_unit():
        if kind in _UNPORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet; ROADMAP.md {_UNPORTED_KINDS[kind]}"
            )
        if is_moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet; ROADMAP.md A.4 (MoE path, gmm kernel K4)"
            )
    if cfg.encoder is not None or cfg.vision_tokens > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder/vision inputs are not ported yet; ROADMAP.md A.5"
        )


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _window(cfg: ArchConfig, kind: str) -> Optional[int]:
    """The attention window of a layer of this kind (None: full causal)."""
    if kind == LayerKind.LOCAL_ATTN and cfg.sliding_window is not None:
        return cfg.sliding_window
    if cfg.local_global_ratio is None and cfg.sliding_window is not None:
        return cfg.sliding_window  # uniformly windowed (mixtral)
    return None


def _index(tree: Params, r: int) -> Params:
    """Repeat ``r`` of a stacked tree, as views."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


# ============================ initialization ===============================


def _init(cfg: ArchConfig, gen: torch.Generator, device: torch.device) -> Params:
    _check_ported(cfg)
    dt = _dtype(cfg)
    lead = (cfg.num_pattern_repeats,)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device)
    blocks: Params = {}
    for u, _ in enumerate(cfg.pattern_unit()):
        p: Params = {
            "norm1": norm_init(cfg.d_model, cfg.norm, dt, device, lead),
            "attn": attn_init(gen, cfg, dt, device, lead),
        }
        if cfg.d_ff > 0:
            p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt, device, lead)
        blocks[f"u{u}"] = p
    params["blocks"] = blocks
    return params


def init_params(cfg: ArchConfig, seed: int = 0, *, device: DeviceLike = None) -> Params:
    """Random parameters with the reference's distributions and tree layout.

    Drawn from a ``torch.Generator`` on the target device seeded with
    ``seed``; the numbers differ from ``repro``'s (``jax.random``), so parity
    checks convert the reference's parameters with ``params_from_jax``.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init(cfg, gen, dev)


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree as meta tensors: shapes and dtypes, no allocation."""
    return _init(cfg, torch.Generator(), torch.device("meta"))


# ============================ forward (full seq) ============================


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    x = params["embed"][tokens].to(dt)
    # the reference rounds sqrt(d_model) to the activation dtype first (on the
    # host here: a device scalar would cost a synchronising copy per call)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 against the (tied) embedding, as the reference's einsum
    with ``preferred_element_type=float32``."""
    unembed = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = torch.matmul(x.float(), unembed.float().t())
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _device_tokens(params: Params, tokens, device: torch.device) -> torch.Tensor:
    if params["embed"].device.type != device.type:
        raise ValueError(f"params lie on {params['embed'].device}, not on {device}")
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def apply_unit(
    cfg: ArchConfig,
    unit_params: Tuple[Params, ...],  # params per unit position (one repeat)
    x: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """One pattern unit of layers."""
    for (kind, _), p in zip(cfg.pattern_unit(), unit_params, strict=True):
        h = apply_norm(p["norm1"], x, cfg.norm)
        x = x + attn_apply(p["attn"], cfg, h, window=_window(cfg, kind), impl=impl)
        if "mlp" in p:
            h = apply_norm(p["norm2"], x, cfg.norm)
            x = x + mlp_apply(p["mlp"], h, cfg.activation)
    return x


def forward(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    impl: str = "auto",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V) fp32, aux loss 0)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    tokens = _device_tokens(params, batch["tokens"], dev)
    x = _embed(cfg, params, tokens)
    n_units = len(cfg.pattern_unit())
    for r in range(cfg.num_pattern_repeats):
        unit = tuple(_index(params["blocks"][f"u{u}"], r) for u in range(n_units))
        x = apply_unit(cfg, unit, x, impl=impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32, device=dev)


# ============================== decode =====================================


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device: DeviceLike = None) -> Params:
    """KV cache stacked per unit position (mirrors the param layout).

    Sliding-window layers only ever need ``min(max_len, window)`` slots.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    cache: Params = {}
    for u, (kind, _) in enumerate(cfg.pattern_unit()):
        window = _window(cfg, kind)
        L = max_len if window is None else min(max_len, window)
        cache[f"u{u}"] = init_kv_cache(
            cfg, batch, L, _dtype(cfg), dev, lead=(cfg.num_pattern_repeats,)
        )
    return cache


def decode_step(
    cfg: ArchConfig,
    params: Params,
    cache: Params,
    token,  # (B, 1) integer token ids
    index: int,  # current position
    *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step; returns (logits (B, 1, V) fp32, the cache updated in place).

    Attention against the cache is plain torch (``_decode_attention``), as in
    the reference, which reaches no kernel here either.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    index = int(index)
    x = _embed(cfg, params, _device_tokens(params, token, dev))
    unit = cfg.pattern_unit()
    for r in range(cfg.num_pattern_repeats):
        for u, (kind, _) in enumerate(unit):
            p = _index(params["blocks"][f"u{u}"], r)
            st = _index(cache[f"u{u}"], r)
            window = _window(cfg, kind)
            L = st["k"].shape[1]
            is_ring = window is not None and L == window
            write_idx = index % L if is_ring else min(index, L - 1)
            fill_len = min(index + 1, L)
            h = apply_norm(p["norm1"], x, cfg.norm)
            a, _ = attn_decode(p["attn"], cfg, h, st, index, write_idx, fill_len)
            x = x + a
            if "mlp" in p:
                h = apply_norm(p["norm2"], x, cfg.norm)
                x = x + mlp_apply(p["mlp"], h, cfg.activation)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(cfg, params, x), cache
