"""Block-pattern model builder (counterpart of ``repro.models.transformer``).

The layer stack is grouped into the architecture's repeating *pattern unit*
with the parameters of each unit position stacked over repeats, exactly as in
the JAX package, so parameter trees convert one to one
(:mod:`repro_torch.models.convert`). Where the reference scans the repeats,
this runs a plain loop over them.

Layer kinds: ATTN and LOCAL_ATTN (norm, attention) and MAMBA (the mixer,
which carries its own norm), each followed by a dense MLP or an MoE
sub-layer; MLSTM and SLSTM, self-contained xLSTM blocks with no MLP.
Encoder and vision inputs raise ``NotImplementedError`` naming their
ROADMAP.md item.

Entry points:
* :func:`init_params`  — random parameters from a seeded ``torch.Generator``
* :func:`forward`      — full-sequence (prefill / scoring) -> logits, aux
* :func:`loss_fn`      — next-token cross-entropy, sequence-chunked softmax (training)
* :func:`init_cache`   — per-layer decode state (KV cache / SSM / xLSTM state), stacked like the params
* :func:`decode_step`  — one token against the cache (updated in place)

Each takes ``device=None``: the card unless the caller passes ``"cpu"``
(:func:`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attn_apply, attn_decode, attn_init, init_kv_cache
from repro_torch.models.config import ArchConfig, LayerKind
from repro_torch.models.layers import Params, apply_norm, embed_init, mlp_apply, mlp_init, norm_init
from repro_torch.models.mamba import mamba_apply, mamba_decode, mamba_init, mamba_state_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.xlstm import (
    mlstm_block_apply,
    mlstm_block_decode,
    mlstm_block_init,
    mlstm_state_init,
    slstm_block_apply,
    slstm_block_decode,
    slstm_block_init,
    slstm_state_init,
)
from repro_torch.tree import leaves

__all__ = [
    "init_params",
    "abstract_params",
    "forward",
    "loss_fn",
    "init_cache",
    "decode_step",
    "apply_unit",
]

_ATTN_KINDS = (LayerKind.ATTN, LayerKind.LOCAL_ATTN)
# self-contained xLSTM blocks (no MLP): (init, decode-state init, decode step)
_XLSTM = {
    LayerKind.MLSTM: (mlstm_block_init, mlstm_state_init, mlstm_block_decode),
    LayerKind.SLSTM: (slstm_block_init, slstm_state_init, slstm_block_decode),
}


def _check_ported(cfg: ArchConfig) -> None:
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


def _layer_init(
    gen: torch.Generator, cfg: ArchConfig, kind: str, is_moe: bool, device: torch.device
) -> Params:
    """One unit position's params, stacked over the repeats (the reference's
    layout: a mamba layer has no ``norm1``, its mixer carries its own norm;
    an xLSTM layer is one self-contained ``block``)."""
    dt = _dtype(cfg)
    lead = (cfg.num_pattern_repeats,)
    p: Params = {}
    if kind in _XLSTM:
        block_init, _, _ = _XLSTM[kind]
        p["block"] = block_init(gen, cfg, dt, device, lead)
        return p
    if kind in _ATTN_KINDS:
        p["norm1"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
        p["attn"] = attn_init(gen, cfg, dt, device, lead)
    else:  # LayerKind.MAMBA
        p["mixer"] = mamba_init(gen, cfg, dt, device, lead)
    if is_moe:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
        p["moe"] = moe_init(gen, cfg, dt, device, lead)
    elif cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt, device, lead)
    return p


def _init(cfg: ArchConfig, gen: torch.Generator, device: torch.device) -> Params:
    _check_ported(cfg)
    dt = _dtype(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device)
    params["blocks"] = {
        f"u{u}": _layer_init(gen, cfg, kind, is_moe, device)
        for u, (kind, is_moe) in enumerate(cfg.pattern_unit())
    }
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


def _ffn(
    cfg: ArchConfig, p: Params, x: torch.Tensor, impl: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP or MoE sub-layer (pre-norm, residual); the MoE's aux loss or None."""
    if "moe" in p:
        mo, aux = moe_apply(p["moe"], cfg, apply_norm(p["norm2"], x, cfg.norm), impl=impl)
        return x + mo, aux
    if "mlp" in p:
        x = x + mlp_apply(p["mlp"], apply_norm(p["norm2"], x, cfg.norm), cfg.activation)
    return x, None


def apply_unit(
    cfg: ArchConfig,
    unit_params: Tuple[Params, ...],  # params per unit position (one repeat)
    x: torch.Tensor,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pattern unit of layers. Returns (x, the unit's summed MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, _), p in zip(cfg.pattern_unit(), unit_params, strict=True):
        if kind == LayerKind.MLSTM:
            x = mlstm_block_apply(p["block"], cfg, x, impl=impl)
            continue
        if kind == LayerKind.SLSTM:
            x = slstm_block_apply(p["block"], cfg, x)
            continue
        if kind in _ATTN_KINDS:
            h = apply_norm(p["norm1"], x, cfg.norm)
            x = x + attn_apply(p["attn"], cfg, h, window=_window(cfg, kind), impl=impl)
        else:
            x = mamba_apply(p["mixer"], cfg, x, impl=impl)
        x, a = _ffn(cfg, p, x, impl)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    impl: str = "auto",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, S, V) fp32, summed MoE aux loss)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    tokens = _device_tokens(params, batch["tokens"], dev)
    x, aux = _run_blocks(cfg, params, _embed(cfg, params, tokens), impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(cfg, params, x), aux


def _run_blocks(
    cfg: ArchConfig, params: Params, x: torch.Tensor, impl: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every repeat of the pattern unit over ``x``; (x, the summed MoE aux loss).

    With ``cfg.remat == "block"`` and autograd recording, each unit runs
    under a non-reentrant ``torch.utils.checkpoint``, as the reference wraps
    its scan body in ``jax.checkpoint``: only the unit's input is kept, and
    the backward pass runs the unit again. The values are the same bits.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_units = len(cfg.pattern_unit())
    for r in range(cfg.num_pattern_repeats):
        unit = tuple(_index(params["blocks"][f"u{u}"], r) for u in range(n_units))
        records = torch.is_grad_enabled() and any(t.requires_grad for t in leaves((x, unit)))
        if cfg.remat == "block" and records:
            x, a = checkpoint(apply_unit, cfg, unit, x, impl=impl, use_reentrant=False)
        else:
            x, a = apply_unit(cfg, unit, x, impl=impl)
        aux = aux + a
    return x, aux


def loss_fn(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    impl: str = "auto",
    loss_chunk: int = 512,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Next-token cross-entropy (mean over B*S tokens) plus the MoE aux loss.

    The softmax runs over sequence chunks of ``min(loss_chunk, S)`` positions
    (one chunk of S where that does not divide S), as the reference's
    ``lax.map`` does: the logits of a chunk are fp32 (:func:`_logits`), each
    chunk gives ``sum(logsumexp - gold)``, the chunks' sums are summed, then
    divided by B*S.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    tokens = _device_tokens(params, batch["tokens"], dev)
    labels = _device_tokens(params, batch["labels"], dev)
    x, aux = _run_blocks(cfg, params, _embed(cfg, params, tokens), impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    B, S, _ = x.shape
    chunk = min(loss_chunk, S)
    if S % chunk:
        chunk = S
    sums = []
    for c0 in range(0, S, chunk):
        logits = _logits(cfg, params, x[:, c0 : c0 + chunk])
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c0 : c0 + chunk, None])[..., 0]
        sums.append(torch.sum(lse - gold))
    return torch.sum(torch.stack(sums)) / (B * S) + aux


# ============================== decode =====================================


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device: DeviceLike = None) -> Params:
    """Decode state stacked per unit position (mirrors the param layout).

    Attention layers get a KV cache; sliding-window ones only ever need
    ``min(max_len, window)`` slots. Mamba layers get their fp32 SSM state
    ``h`` (B, Di, N) and conv window (B, d_conv - 1, Di); mLSTM layers C, n,
    m and sLSTM layers c, n, m, h in fp32, each with its conv window.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    lead = (cfg.num_pattern_repeats,)
    cache: Params = {}
    for u, (kind, _) in enumerate(cfg.pattern_unit()):
        if kind in _XLSTM:
            _, state_init, _ = _XLSTM[kind]
            cache[f"u{u}"] = state_init(cfg, batch, _dtype(cfg), dev, lead)
            continue
        if kind not in _ATTN_KINDS:
            cache[f"u{u}"] = mamba_state_init(cfg, batch, _dtype(cfg), dev, lead)
            continue
        window = _window(cfg, kind)
        L = max_len if window is None else min(max_len, window)
        cache[f"u{u}"] = init_kv_cache(cfg, batch, L, _dtype(cfg), dev, lead=lead)
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

    Attention against the cache and the one-token mamba, mLSTM and sLSTM
    steps are plain torch, as in the reference, which reaches no kernel here
    either. The MoE runs its dispatch over the batch's B tokens and its expert
    products through ``ops.gmm`` at ``impl="auto"``: on the card, K4 at one
    row per expert.
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
            if kind in _XLSTM:
                _, _, block_decode = _XLSTM[kind]
                x, _ = block_decode(p["block"], cfg, x, st)
                continue
            if kind in _ATTN_KINDS:
                window = _window(cfg, kind)
                L = st["k"].shape[1]
                is_ring = window is not None and L == window
                write_idx = index % L if is_ring else min(index, L - 1)
                fill_len = min(index + 1, L)
                h = apply_norm(p["norm1"], x, cfg.norm)
                a, _ = attn_decode(p["attn"], cfg, h, st, index, write_idx, fill_len)
                x = x + a
            else:
                x, _ = mamba_decode(p["mixer"], cfg, x, st)
            x, _ = _ffn(cfg, p, x, "auto")
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(cfg, params, x), cache
