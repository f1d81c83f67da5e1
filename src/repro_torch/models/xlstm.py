"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro.models.xlstm``, with the xLSTM paper's residual
block structure:

* mLSTM block: norm -> up-proj (2x expansion, gated z branch) -> causal conv4
  -> q/k from the conv path, v from the pre-conv path -> per-head scalar i/f
  gates -> chunkwise mLSTM (:func:`repro_torch.kernels.ops.mlstm`, the CUDA
  kernel on the card) -> z-gate -> down-proj.
* sLSTM block: norm -> causal conv4 -> 4-head sLSTM with exponential gating
  and block-diagonal recurrence -> group norm; then a 4/3 GeLU FFN sub-block.
  The recurrence is a Python loop over T in plain torch, as the reference's
  is a ``lax.scan`` with no kernel; the four recurrent matrices are stacked
  once before the loop, so each step runs one product.

The causal conv is shared with the Mamba mixer (``repro_torch.models.mamba``).
For decode both blocks carry O(1) recurrent state, updated in place.
Initialisers take ``lead``, the stacked-repeat axis of the parameter tree.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import parallel
from repro_torch.distributed.hints import active_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    Params,
    _gelu,
    apply_norm,
    dense,
    dense_init,
    norm_init,
    truncated_normal,
)

__all__ = [
    "CONV",
    "EXPAND",
    "mlstm_block_init",
    "mlstm_block_apply",
    "mlstm_block_decode",
    "mlstm_state_init",
    "slstm_block_init",
    "slstm_block_apply",
    "slstm_block_decode",
    "slstm_state_init",
]

EXPAND = 2  # mLSTM projection expansion factor
CONV = 4  # causal conv width


def _conv_init(
    gen: torch.Generator, width: int, channels: int, dtype: torch.dtype, device,
    lead: Sequence[int] = (),
) -> torch.Tensor:
    """``(*lead, width, channels)`` taps with std ``1/sqrt(width)``."""
    return truncated_normal(gen, (*lead, width, channels), 1.0 / math.sqrt(width), dtype, device)


def _causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (W, C).

    The taps are summed in ``x``'s dtype from zero in tap order ``i = 0..W-1``,
    as the reference does, so bf16 rounds at the same places.
    """
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i : i + T, :] * w[W - 1 - i][None, None, :]
    return out


def _conv_step(w: torch.Tensor, state: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv in fp32: (silu(conv) (B, 1, C) in
    ``x``'s dtype, the new window). The taps are flipped: the window's last
    row is the current token and pairs with ``w[0]``."""
    window = torch.cat([state, x.to(state.dtype)], dim=1)
    xc = torch.einsum("bwc,wc->bc", window.float(), _flip_taps(w).float())
    return F.silu(xc)[:, None, :].to(x.dtype), window[:, 1:]


def _flip_taps(w: torch.Tensor) -> torch.Tensor:
    """``w`` (W, C) reversed along its taps (on a mesh, on each local shard)."""
    mesh = active_mesh(w)
    return torch.flip(w, dims=(0,)) if mesh is None else parallel.flip_taps(w, mesh)


# ------------------------------ mLSTM block --------------------------------


def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    di = EXPAND * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_block_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Params:
    """The reference's layout; the gate weights ``w_i`` and ``w_f`` are fp32
    in every model dtype."""
    d = cfg.d_model
    di, H, _ = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "norm": norm_init(d, cfg.norm, dtype, device, lead),
        "w_up": dense_init(gen, d, 2 * di, dtype, device, lead=lead),
        "conv": _conv_init(gen, CONV, di, dtype, device, lead),
        "wq": dense_init(gen, di, di, dtype, device, lead=lead),
        "wk": dense_init(gen, di, di, dtype, device, lead=lead),
        "wv": dense_init(gen, di, di, dtype, device, lead=lead),
        "w_i": dense_init(gen, di, H, f32, device, lead=lead),
        "w_f": dense_init(gen, di, H, f32, device, lead=lead),
        "w_down": dense_init(gen, di, d, dtype, device, lead=lead),
        "out_norm": norm_init(di, "rmsnorm", dtype, device, lead),
    }


def _mlstm_qkvif(p: Params, cfg: ArchConfig, x: torch.Tensor):
    """q, k, v (B, T, H, dh) in x's dtype, fp32 gates (B, T, H), z and xin (B, T, di)."""
    B, T, _ = x.shape
    _, H, dh = _mlstm_dims(cfg)
    h = apply_norm(p["norm"], x, cfg.norm)
    xin, z = torch.chunk(dense(p["w_up"], h), 2, dim=-1)
    xc = F.silu(_causal_conv(p["conv"], xin))
    q = dense(p["wq"], xc).reshape(B, T, H, dh)
    k = dense(p["wk"], xc).reshape(B, T, H, dh)
    v = dense(p["wv"], xin).reshape(B, T, H, dh)
    xf = xc.float()
    return q, k, v, xf @ p["w_i"], xf @ p["w_f"], z, xin


def mlstm_block_apply(
    p: Params, cfg: ArchConfig, x: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    B, T, _ = x.shape
    di, _, _ = _mlstm_dims(cfg)
    q, k, v, ig, fg, z, _ = _mlstm_qkvif(p, cfg, x)
    h = ops.mlstm(q, k, v, ig, fg, impl=impl).reshape(B, T, di)
    h = apply_norm(p["out_norm"], h, "rmsnorm") * F.silu(z)
    return x + dense(p["w_down"], h)


def mlstm_state_init(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Dict[str, torch.Tensor]:
    """C, n, m in fp32 (m starts at the finite -1e30), the conv window in ``dtype``."""
    di, H, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((*lead, batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((*lead, batch, H, dh), dtype=f32, device=device),
        "m": torch.full((*lead, batch, H), NEG_INF, dtype=f32, device=device),
        "conv": torch.zeros((*lead, batch, CONV - 1, di), dtype=dtype, device=device),
    }


def mlstm_block_decode(
    p: Params, cfg: ArchConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step on x (B, 1, d); the state is updated in place and returned.

    k is scaled by ``1/sqrt(dh)`` in x's dtype here (the forward scales it in
    fp32), as in the reference.
    """
    B = x.shape[0]
    di, H, dh = _mlstm_dims(cfg)
    h = apply_norm(p["norm"], x, cfg.norm)
    xin, z = torch.chunk(dense(p["w_up"], h), 2, dim=-1)  # (B, 1, di)
    xc, window = _conv_step(p["conv"], state["conv"], xin)
    q = dense(p["wq"], xc).reshape(B, H, dh)
    k = dense(p["wk"], xc).reshape(B, H, dh) / math.sqrt(dh)
    v = dense(p["wv"], xin).reshape(B, H, dh)
    xf = xc.reshape(B, di).float()
    ig, fg = xf @ p["w_i"], xf @ p["w_f"]  # (B, H)
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + state["m"], ig)
    i_w = torch.exp(ig - m_new)[..., None]  # (B, H, 1)
    decay = torch.exp(lf + state["m"] - m_new)[..., None]
    C = decay[..., None] * state["C"] + i_w[..., None] * k[..., :, None] * v[..., None, :]
    n = decay * state["n"] + i_w * k
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    hout = (num / den).reshape(B, 1, di).to(x.dtype)
    hout = apply_norm(p["out_norm"], hout, "rmsnorm") * F.silu(z)
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    state["conv"].copy_(window)
    return x + dense(p["w_down"], hout), state


# ------------------------------ sLSTM block --------------------------------


def _stack_r(gen: torch.Generator, H: int, dh: int, dtype: torch.dtype, device,
             lead: Sequence[int] = ()) -> torch.Tensor:
    """A block-diagonal recurrent matrix ``(*lead, H, dh, dh)``, std ``1/sqrt(dh)``."""
    return truncated_normal(gen, (*lead, H, dh, dh), 1.0 / math.sqrt(dh), dtype, device)


def slstm_block_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    f = int(d * 4 / 3)
    return {
        "norm": norm_init(d, cfg.norm, dtype, device, lead),
        "conv": _conv_init(gen, CONV, d, dtype, device, lead),
        "w_i": dense_init(gen, d, d, dtype, device, lead=lead),
        "w_f": dense_init(gen, d, d, dtype, device, lead=lead),
        "w_z": dense_init(gen, d, d, dtype, device, lead=lead),
        "w_o": dense_init(gen, d, d, dtype, device, lead=lead),
        "r_i": _stack_r(gen, H, dh, dtype, device, lead),
        "r_f": _stack_r(gen, H, dh, dtype, device, lead),
        "r_z": _stack_r(gen, H, dh, dtype, device, lead),
        "r_o": _stack_r(gen, H, dh, dtype, device, lead),
        "gn": norm_init(d, "rmsnorm", dtype, device, lead),
        "ffn_norm": norm_init(d, cfg.norm, dtype, device, lead),
        "w_ffn_up": dense_init(gen, d, f, dtype, device, lead=lead),
        "w_ffn_down": dense_init(gen, f, d, dtype, device, lead=lead),
    }


def slstm_state_init(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Dict[str, torch.Tensor]:
    """c, n, m, h in fp32 (n starts at 1, not 0), the conv window in ``dtype``."""
    d = cfg.d_model
    f32 = torch.float32
    return {
        "c": torch.zeros((*lead, batch, d), dtype=f32, device=device),
        "n": torch.ones((*lead, batch, d), dtype=f32, device=device),
        "m": torch.zeros((*lead, batch, d), dtype=f32, device=device),
        "h": torch.zeros((*lead, batch, d), dtype=f32, device=device),
        "conv": torch.zeros((*lead, batch, CONV - 1, d), dtype=dtype, device=device),
    }


def _recurrent(p: Params) -> torch.Tensor:
    """``r_i, r_f, r_z, r_o`` stacked in fp32 as ``(H, dh, 4, dh)``: one product
    per step gives the four gates' recurrent terms in the gates' layout."""
    return torch.stack([p[k].float() for k in ("r_i", "r_f", "r_z", "r_o")], dim=2)


def _slstm_step(R: torch.Tensor, carry, gates: torch.Tensor):
    """One sLSTM time step. R from :func:`_recurrent`; gates: the input
    projections (B, 4d) fp32. Returns the new carry (c, n, m, h)."""
    c, n, m, h_prev = carry
    B = h_prev.shape[0]
    H, dh = R.shape[0], R.shape[1]
    rec = torch.einsum("bhd,hdke->bkhe", h_prev.reshape(B, H, dh), R).reshape(B, 4 * H * dh)
    gi, gf, gz, go = torch.chunk(gates + rec, 4, dim=-1)
    lf = F.logsigmoid(gf)
    m_new = torch.maximum(lf + m, gi)
    i_w = torch.exp(gi - m_new)
    f_w = torch.exp(lf + m - m_new)
    c_new = f_w * c + i_w * torch.tanh(gz)
    n_new = torch.clamp_min(f_w * n + i_w, 1e-6)
    h_new = torch.sigmoid(go) * (c_new / n_new)
    return c_new, n_new, m_new, h_new


def _slstm_gates(p: Params, h: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """The four gates' input projections, (..., 4d) fp32: i and f from the conv
    path, z and o from the normed input."""
    return torch.cat(
        [dense(p["w_i"], xc), dense(p["w_f"], xc), dense(p["w_z"], h), dense(p["w_o"], h)],
        dim=-1,
    ).float()


def _slstm_scan(R: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """The recurrence over T from the empty state: gates (B, T, 4d) fp32 ->
    hidden states (B, T, d) fp32. A Python loop of a few launches a step."""
    if active_mesh(gates) is not None:  # on a mesh: per batch row, on the local shards
        return parallel.slstm_scan(_slstm_scan, R, gates)
    B, T, d4 = gates.shape
    d = d4 // 4
    f32 = torch.float32
    carry = (
        torch.zeros((B, d), dtype=f32, device=gates.device),
        torch.ones((B, d), dtype=f32, device=gates.device),
        torch.zeros((B, d), dtype=f32, device=gates.device),
        torch.zeros((B, d), dtype=f32, device=gates.device),
    )
    hs = torch.empty((B, T, d), dtype=f32, device=gates.device)
    for t in range(T):
        carry = _slstm_step(R, carry, gates[:, t])
        hs[:, t] = carry[3]
    return hs


def _slstm_out(p: Params, hs: torch.Tensor) -> torch.Tensor:
    return apply_norm(p["gn"], hs, "rmsnorm")


def _slstm_ffn(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    hf = apply_norm(p["ffn_norm"], x, cfg.norm)
    return x + dense(p["w_ffn_down"], _gelu(dense(p["w_ffn_up"], hf)))


def slstm_block_apply(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p["norm"], x, cfg.norm)
    xc = F.silu(_causal_conv(p["conv"], h))
    hs = _slstm_scan(_recurrent(p), _slstm_gates(p, h, xc)).to(x.dtype)
    return _slstm_ffn(p, cfg, x + _slstm_out(p, hs))


def slstm_block_decode(
    p: Params, cfg: ArchConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step on x (B, 1, d); the state is updated in place and returned."""
    h = apply_norm(p["norm"], x, cfg.norm)  # (B, 1, d)
    xc, window = _conv_step(p["conv"], state["conv"], h)
    carry = (state["c"], state["n"], state["m"], state["h"])
    new = _slstm_step(_recurrent(p), carry, _slstm_gates(p, h, xc)[:, 0])
    out = _slstm_ffn(p, cfg, x + _slstm_out(p, new[3][:, None, :].to(x.dtype)))
    for k, t in zip(("c", "n", "m", "h"), new, strict=True):
        state[k].copy_(t)
    state["conv"].copy_(window)
    return out, state
