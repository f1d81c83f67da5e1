"""Block-pattern model builder (counterpart of ``repro.models.transformer``).

The layer stack is grouped into the architecture's repeating *pattern unit*
with the parameters of each unit position stacked over repeats, exactly as in
the JAX package, so parameter trees convert one to one
(:mod:`repro_torch.models.convert`). Where the reference scans the repeats,
this runs a plain loop over them.

Layer kinds: ATTN and LOCAL_ATTN (norm, attention) and MAMBA (the mixer,
which carries its own norm), each followed by a dense MLP or an MoE
sub-layer; MLSTM and SLSTM, self-contained xLSTM blocks with no MLP.

Modality inputs, as in the reference: an encoder-decoder config (whisper)
runs a bidirectional encoder over ``batch["enc_frames"]`` (precomputed frame
embeddings; the conv frontend is a stub) and gives each attention layer a
cross-attention sub-layer over its output, after self-attention and before
the MLP; a vision config (phi-3-vision) prepends ``batch["img_embeds"]``
(precomputed patch embeddings) to the text before the blocks and cuts those
positions off after the final norm.

Entry points:
* :func:`init_params`  — random parameters from a seeded ``torch.Generator``
* :func:`forward`      — full-sequence (prefill / scoring) -> logits, aux
* :func:`loss_fn`      — next-token cross-entropy, sequence-chunked softmax (training)
* :func:`encode`       — the encoder's output for ``decode_step``'s cross-attention
* :func:`init_cache`   — per-layer decode state (KV cache / SSM / xLSTM state), stacked like the params
* :func:`decode_step`  — one token against the cache (updated in place)

Each takes ``device=None``: the card unless the caller passes ``"cpu"``
(:func:`repro_torch.device.resolve_device`).

While a torch profiler records (:mod:`repro_torch.obs`), ``forward`` and
``decode_step`` open the spans ``rt.forward`` and ``rt.decode_step``; inside
them each layer ``rt.layer.attention``, ``rt.layer.mamba``,
``rt.layer.mlstm`` or ``rt.layer.slstm`` (with the indexing of its
parameters and cache), and its sub-layers ``rt.attention`` (norm and
self-attention), ``rt.mamba`` (the mixer), ``rt.moe`` (norm and MoE, whose
own spans and counter :mod:`repro_torch.models.moe` names) or ``rt.mlp``
(norm and dense MLP); then ``rt.logits`` (final norm and logits). The
encoder and cross-attention have no span of their own.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import parallel
from repro_torch.distributed.hints import active_mesh, hint
from repro_torch.models.attention import (
    attn_apply,
    attn_decode,
    attn_init,
    cross_attn_apply,
    cross_attn_init,
    init_kv_cache,
)
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
    "encode",
    "init_cache",
    "decode_step",
    "apply_unit",
]

_ATTN_KINDS = (LayerKind.ATTN, LayerKind.LOCAL_ATTN)
# the span of one layer of each kind (repro_torch.obs)
_LAYER_SPAN = {LayerKind.ATTN: "rt.layer.attention", LayerKind.LOCAL_ATTN: "rt.layer.attention",
               LayerKind.MAMBA: "rt.layer.mamba", LayerKind.MLSTM: "rt.layer.mlstm",
               LayerKind.SLSTM: "rt.layer.slstm"}
# self-contained xLSTM blocks (no MLP): (init, decode-state init, decode step)
_XLSTM = {
    LayerKind.MLSTM: (mlstm_block_init, mlstm_state_init, mlstm_block_decode),
    LayerKind.SLSTM: (slstm_block_init, slstm_state_init, slstm_block_decode),
}


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
    an xLSTM layer is one self-contained ``block``; in an encoder-decoder
    config an attention layer also has ``cross_norm`` and ``cross``)."""
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
        if cfg.encoder is not None:
            p["cross_norm"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
            p["cross"] = cross_attn_init(gen, cfg, dt, device, lead)
    else:  # LayerKind.MAMBA
        p["mixer"] = mamba_init(gen, cfg, dt, device, lead)
    if is_moe:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
        p["moe"] = moe_init(gen, cfg, dt, device, lead)
    elif cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, device, lead)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt, device, lead)
    return p


def _encoder_init(gen: torch.Generator, cfg: ArchConfig, device: torch.device) -> Params:
    """The whisper-style encoder: ``encoder.n_layers`` bidirectional attention
    layers (norm, attention, norm, MLP) stacked over the layers, its final
    norm and a learned position table (``n_frames``, d) scaled by 0.02."""
    dt = _dtype(cfg)
    d = cfg.d_model
    lead = (cfg.encoder.n_layers,)
    layers = {
        "norm1": norm_init(d, cfg.norm, dt, device, lead),
        "attn": attn_init(gen, cfg, dt, device, lead),
        "norm2": norm_init(d, cfg.norm, dt, device, lead),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.activation, dt, device, lead),
    }
    return {
        "layers": layers,
        "final_norm": norm_init(d, cfg.norm, dt, device),
        "pos": embed_init(gen, cfg.encoder.n_frames, d, dt, device) * 0.02,
    }


def _init(cfg: ArchConfig, gen: torch.Generator, device: torch.device) -> Params:
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
    if cfg.encoder is not None:
        params["encoder"] = _encoder_init(gen, cfg, device)
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
    mesh = active_mesh(params["embed"])
    x = params["embed"][tokens] if mesh is None else parallel.embed(params["embed"], tokens, mesh)
    x = hint(x.to(dt), "dp", None, None)
    # the reference rounds sqrt(d_model) to the activation dtype first (on the
    # host here: a device scalar would cost a synchronising copy per call)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()


# columns of d_model that the tensor cores sum before the running sum takes
# them in an fp32 add: their own accumulation loses bits in proportion to its
# length (on the H100, against an fp64 product at nemotron's 18,432 columns:
# one GEMM 2.4e-5 of max|logits| off, chunks of 2,048 2.4e-6, the fp32 upcast
# 4.8e-6; chip_smoke.py's logits_product phase)
LOGITS_K_CHUNK = 2048


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 against the (tied) embedding, as the reference's einsum
    with ``preferred_element_type=float32`` (:func:`_logits_product`). On a
    mesh each rank takes that product on its vocabulary slice
    (:func:`repro_torch.distributed.parallel.logits`)."""
    unembed = params["embed"] if cfg.tie_embeddings else params["unembed"]
    mesh = active_mesh(unembed)
    if mesh is not None:
        return parallel.logits(functools.partial(_logits_product, cfg), unembed, x, mesh)
    return _logits_product(cfg, unembed, x)


def _logits_product(cfg: ArchConfig, unembed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ unembed.T`` in fp32, soft-capped as the config says.

    On the card, with bf16 operands and autograd not recording, that is a
    bf16 GEMM with fp32 output (``torch.mm(..., out_dtype=float32)``) over
    each ``LOGITS_K_CHUNK`` columns of d_model, the chunks after the first
    added to the fp32 logits in place by ``addmm``'s epilogue: the products
    of two bf16 numbers are exact in fp32, so only the order and rounding of
    the sums differ from the upcast below, and no fp32 copy of the
    unembedding is made (18.9 GB for nemotron-4-340b). The CPU, fp32 configs
    and the training path (autograd through the product) upcast both
    operands.
    """
    records = torch.is_grad_enabled() and (x.requires_grad or unembed.requires_grad)
    if (x.device.type == "cuda" and x.dtype == unembed.dtype == torch.bfloat16
            and not records):
        x2, kc = x.reshape(-1, x.shape[-1]), LOGITS_K_CHUNK
        logits = torch.mm(x2[:, :kc], unembed[:, :kc].t(), out_dtype=torch.float32)
        for k0 in range(kc, x2.shape[1], kc):
            torch.addmm(logits, x2[:, k0 : k0 + kc], unembed[:, k0 : k0 + kc].t(),
                        out_dtype=torch.float32, out=logits)
        logits = logits.view(*x.shape[:-1], unembed.shape[0])
    else:
        logits = torch.matmul(x.float(), unembed.float().t())
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _device_input(
    params: Params, a, device: torch.device, dtype: torch.dtype = torch.long
) -> torch.Tensor:
    """A batch input (token ids, or frame / patch embeddings cast to the
    activation dtype) as a tensor on ``device``, where the params must lie; a
    tensor given on another kind of device raises."""
    if params["embed"].device.type != device.type:
        raise ValueError(f"params lie on {params['embed'].device}, not on {device}")
    if isinstance(a, torch.Tensor) and a.device.type != device.type:
        raise ValueError(f"a batch input lies on {a.device}, not on {device}")
    return torch.as_tensor(a, device=device).to(dtype)


def _inputs(
    cfg: ArchConfig, params: Params, batch, device: torch.device, impl: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """(x entering the blocks, the encoder's output or None, the number of
    image positions prepended to x)."""
    x = _embed(cfg, params, _device_input(params, batch["tokens"], device))
    n_img = 0
    if cfg.vision_tokens > 0 and "img_embeds" in batch:
        img = _device_input(params, batch["img_embeds"], device, _dtype(cfg))
        x = torch.cat([img, x], dim=1)
        n_img = img.shape[1]
    enc_out = None
    if cfg.encoder is not None:
        frames = _device_input(params, batch["enc_frames"], device, _dtype(cfg))
        enc_out = _run_encoder(cfg, params, frames, impl)
    return x, enc_out, n_img


def _run_encoder(cfg: ArchConfig, params: Params, frames: torch.Tensor, impl: str) -> torch.Tensor:
    """The encoder over precomputed frame embeddings: positions added, then
    per layer norm, bidirectional self-attention (rope at 0..T-1, as the
    reference's ``attn_apply`` applies it), norm, MLP; then the final norm.
    It runs outside the decoder's remat units, as the reference's does."""
    enc = params["encoder"]
    x = frames + enc["pos"][None, : frames.shape[1]].to(frames.dtype)
    for r in range(cfg.encoder.n_layers):
        lp = _index(enc["layers"], r)
        h = apply_norm(lp["norm1"], x, cfg.norm)
        x = x + attn_apply(lp["attn"], cfg, h, causal=False, impl=impl)
        h = apply_norm(lp["norm2"], x, cfg.norm)
        x = x + mlp_apply(lp["mlp"], h, cfg.activation)
    return apply_norm(enc["final_norm"], x, cfg.norm)


def encode(
    cfg: ArchConfig,
    params: Params,
    enc_frames,  # (B, n_frames, d) frame embeddings
    *,
    impl: str = "auto",
    device: DeviceLike = None,
) -> torch.Tensor:
    """The encoder's output (B, T, d) in the activation dtype, for
    :func:`decode_step`'s ``enc_out``; ``forward`` and ``loss_fn`` run the
    same encoder on ``batch["enc_frames"]``."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.name} has no encoder")
    dev = resolve_device(device)
    return _run_encoder(cfg, params, _device_input(params, enc_frames, dev, _dtype(cfg)), impl)


def _ffn(
    cfg: ArchConfig, p: Params, x: torch.Tensor, impl: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP or MoE sub-layer (pre-norm, residual); the MoE's aux loss or None."""
    if "moe" in p:
        with obs.span("rt.moe"):
            mo, aux = moe_apply(p["moe"], cfg, apply_norm(p["norm2"], x, cfg.norm), impl=impl)
            return x + mo, aux
    if "mlp" in p:
        with obs.span("rt.mlp"):
            x = x + mlp_apply(p["mlp"], apply_norm(p["norm2"], x, cfg.norm), cfg.activation)
    return x, None


def _layer(
    cfg: ArchConfig, kind: str, p: Params, x: torch.Tensor, enc_out: Optional[torch.Tensor],
    impl: str,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of a pattern unit: (x, its MoE aux loss or None)."""
    if kind == LayerKind.MLSTM:
        return mlstm_block_apply(p["block"], cfg, x, impl=impl), None
    if kind == LayerKind.SLSTM:
        return slstm_block_apply(p["block"], cfg, x), None
    # on a mesh the residual stream is pinned batch-sharded, d replicated, as
    # the reference pins it between layers (its measured fix for gathers
    # between blocks); the port pins it after each sub-layer too, where
    # DTensor's propagation would otherwise shard the sequence
    if kind in _ATTN_KINDS:
        with obs.span("rt.attention"):
            h = apply_norm(p["norm1"], x, cfg.norm)
            x = hint(x + attn_apply(p["attn"], cfg, h, window=_window(cfg, kind), impl=impl),
                     "dp", None, None)
        if enc_out is not None and "cross" in p:
            h = apply_norm(p["cross_norm"], x, cfg.norm)
            x = hint(x + cross_attn_apply(p["cross"], cfg, h, enc_out, impl=impl),
                     "dp", None, None)
    else:
        with obs.span("rt.mamba"):
            x = hint(mamba_apply(p["mixer"], cfg, x, impl=impl), "dp", None, None)
    x, a = _ffn(cfg, p, x, impl)
    return hint(x, "dp", None, None), a


def apply_unit(
    cfg: ArchConfig,
    unit_params: Tuple[Params, ...],  # params per unit position (one repeat)
    x: torch.Tensor,
    *,
    enc_out: Optional[torch.Tensor] = None,
    impl: str = "auto",
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pattern unit of layers. Returns (x, the unit's summed MoE aux loss).

    With ``enc_out``, each attention layer that has ``cross`` attends over it
    after its self-attention. With ``remat``, each layer runs under a
    non-reentrant ``torch.utils.checkpoint``: only its input is kept, and the
    backward pass runs it again (the same bits)."""
    return _unit(cfg, unit_params, None, x, enc_out, impl, remat)


def _unit(
    cfg: ArchConfig, unit_params: Tuple[Params, ...], r: Optional[int], x: torch.Tensor,
    enc_out: Optional[torch.Tensor], impl: str, remat: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_unit` over one repeat's params, or, given ``r``, over the
    stacked params, each layer's repeat ``r`` indexed inside its layer span."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = hint(x, "dp", None, None)
    for (kind, _), p in zip(cfg.pattern_unit(), unit_params, strict=True):
        with obs.span(_LAYER_SPAN[kind]):
            if r is not None:
                p = _index(p, r)
            if remat:
                x, a = checkpoint(_layer, cfg, kind, p, x, enc_out, impl, use_reentrant=False)
            else:
                x, a = _layer(cfg, kind, p, x, enc_out, impl)
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
    """Full-sequence forward. Returns (logits (B, S, V) fp32, summed MoE aux loss).

    ``batch`` holds ``tokens`` (B, S), and ``enc_frames`` (B, T, d) for an
    encoder-decoder config or ``img_embeds`` (B, P, d) for a vision one; the
    logits are the text positions' only."""
    with obs.span("rt.forward"):
        dev = resolve_device(device)
        x, enc_out, n_img = _inputs(cfg, params, batch, dev, impl)
        x, aux = _run_blocks(cfg, params, x, enc_out, impl)
        with obs.span("rt.logits"):
            x = apply_norm(params["final_norm"], x, cfg.norm)
            return _logits(cfg, params, x[:, n_img:]), aux


def _run_blocks(
    cfg: ArchConfig, params: Params, x: torch.Tensor, enc_out: Optional[torch.Tensor], impl: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every repeat of the pattern unit over ``x``; (x, the summed MoE aux loss).

    With ``cfg.remat == "block"`` and autograd recording, each layer of a
    unit runs under a non-reentrant ``torch.utils.checkpoint``, where the
    reference wraps its scan body, the unit, in ``jax.checkpoint``: only the
    layer's input is kept, and the backward pass runs the layer again. The
    values are the same bits; a unit of many layers (gemma3-1b's 26 are one)
    keeps one layer's activations at a time instead of the unit's.
    ``enc_out`` is an input of every layer, so its gradient flows through the
    recomputation too.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the stacks: a repeat's views require grad where their stack does
    stacks = tuple(params["blocks"][f"u{u}"] for u in range(len(cfg.pattern_unit())))
    for r in range(cfg.num_pattern_repeats):
        records = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in leaves((x, enc_out, stacks)))
        x, a = _unit(cfg, stacks, r, x, enc_out, impl, remat=cfg.remat == "block" and records)
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
    divided by B*S. S counts the text positions only: image positions are cut
    off after the final norm, as in :func:`forward`.
    """
    dev = resolve_device(device)
    x, enc_out, n_img = _inputs(cfg, params, batch, dev, impl)
    labels = _device_input(params, batch["labels"], dev)
    x, aux = _run_blocks(cfg, params, x, enc_out, impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)[:, n_img:]
    B, S, _ = x.shape
    chunk = min(loss_chunk, S)
    if S % chunk:
        chunk = S
    unembed = params["embed"] if cfg.tie_embeddings else params["unembed"]
    mesh = active_mesh(x)
    if mesh is not None:  # the vocab-parallel cross-entropy on local shards
        ce = parallel.ce_sum(functools.partial(_ce_sum, cfg, chunk=chunk), unembed, x, labels, mesh)
    else:
        ce = _ce_sum(cfg, unembed, x, labels, chunk=chunk)
    return ce / (B * S) + aux


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp - gold`` (labels with a trailing 1 dim)."""
    return torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels)[..., 0]


def _ce_sum(
    cfg: ArchConfig, unembed: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
    nll: Optional[Callable] = None, *, chunk: int,
) -> torch.Tensor:
    """``sum(logsumexp - gold)`` over the tokens, the softmax over sequence
    chunks of ``chunk`` positions; ``nll`` (default :func:`_token_nll`)
    gives each token's term from a chunk's logits."""
    nll = nll or _token_nll
    sums = []
    for c0 in range(0, x.shape[1], chunk):
        logits = _logits_product(cfg, unembed, x[:, c0 : c0 + chunk])
        sums.append(torch.sum(nll(logits, labels[:, c0 : c0 + chunk, None])))
    return torch.sum(torch.stack(sums))


# ============================== decode =====================================


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device: DeviceLike = None) -> Params:
    """Decode state stacked per unit position (mirrors the param layout).

    Attention layers get a KV cache; sliding-window ones only ever need
    ``min(max_len, window)`` slots. Mamba layers get their fp32 SSM state
    ``h`` (B, Di, N) and conv window (B, d_conv - 1, Di); mLSTM layers C, n,
    m and sLSTM layers c, n, m, h in fp32, each with its conv window.
    Cross-attention keeps no cache: it reads ``enc_out`` whole each step.
    """
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
    enc_out: Optional[torch.Tensor] = None,  # (B, T, d) from :func:`encode`
    impl: str = "auto",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step; returns (logits (B, 1, V) fp32, the cache updated in place).

    Attention against the cache goes through ``ops.decode_attention``: on the
    card, K5, which reads the filled slots of the cache once in its own type
    (the reference reaches no kernel here; a cache on a mesh takes the plain
    split-K path). The one-token mamba, mLSTM and sLSTM steps are plain torch,
    as in the reference. The MoE runs its dispatch over the batch's B tokens
    and its expert products through ``ops.gmm``: on the card, K4 at one row
    per expert. With ``enc_out``, every attention layer that has ``cross``
    attends its one token over it: on the card, flash attention at Sq = 1.
    ``impl`` is the route of those three (``"auto"``: the kernels on the card;
    ``"ref"``: their plain versions on any device).
    """
    with obs.span("rt.decode_step"):
        dev = resolve_device(device)
        index = int(index)
        if enc_out is not None and enc_out.device.type != dev.type:
            raise ValueError(f"enc_out lies on {enc_out.device}, not on {dev}")
        x = _embed(cfg, params, _device_input(params, token, dev))
        unit = cfg.pattern_unit()
        for r in range(cfg.num_pattern_repeats):
            for u, (kind, _) in enumerate(unit):
                with obs.span(_LAYER_SPAN[kind]):
                    x = _decode_layer(cfg, kind, _index(params["blocks"][f"u{u}"], r),
                                      _index(cache[f"u{u}"], r), x, index, enc_out, impl)
        with obs.span("rt.logits"):
            x = apply_norm(params["final_norm"], x, cfg.norm)
            return _logits(cfg, params, x), cache


def _decode_layer(
    cfg: ArchConfig, kind: str, p: Params, st: Params, x: torch.Tensor, index: int,
    enc_out: Optional[torch.Tensor], impl: str,
) -> torch.Tensor:
    """One layer of :func:`decode_step` on its params ``p`` and state ``st``."""
    if kind in _XLSTM:
        _, _, block_decode = _XLSTM[kind]
        return block_decode(p["block"], cfg, x, st)[0]
    if kind in _ATTN_KINDS:
        window = _window(cfg, kind)
        L = st["k"].shape[1]
        is_ring = window is not None and L == window
        write_idx = index % L if is_ring else min(index, L - 1)
        fill_len = min(index + 1, L)
        with obs.span("rt.attention"):
            h = apply_norm(p["norm1"], x, cfg.norm)
            a, _ = attn_decode(p["attn"], cfg, h, st, index, write_idx, fill_len, impl=impl)
            x = x + a
        if enc_out is not None and "cross" in p:
            h = apply_norm(p["cross_norm"], x, cfg.norm)
            x = x + cross_attn_apply(p["cross"], cfg, h, enc_out, impl=impl)
    else:
        with obs.span("rt.mamba"):
            x, _ = mamba_decode(p["mixer"], cfg, x, st)
    return _ffn(cfg, p, x, impl)[0]
