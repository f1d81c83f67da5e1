"""Mamba (selective SSM) mixer layer: the jamba hybrid's workhorse.

Counterpart of ``repro.models.mamba``. Standard Mamba-1 block: in-proj (2x
expand, gated z branch) -> causal conv4 -> selective (input-dependent)
dt/B/C -> selective scan (:func:`repro_torch.kernels.ops.mamba_scan`, the
CUDA kernel on the card) -> z-gate -> out-proj. Decode carries an O(1)
``(d_inner, d_state)`` fp32 state and the conv window, updated in place.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig, MambaConfig
from repro_torch.models.layers import Params, apply_norm, dense, dense_init, norm_init
from repro_torch.models.xlstm import _causal_conv, _conv_init, _conv_step  # shared depthwise conv

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_state_init"]


def _mc(cfg: ArchConfig) -> MambaConfig:
    return cfg.mamba or MambaConfig()


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    mc = _mc(cfg)
    di = mc.expand * cfg.d_model
    dtr = mc.dt_rank or max(cfg.d_model // 16, 1)
    return di, mc.d_state, dtr


def mamba_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Params:
    d = cfg.d_model
    di, N, dtr = _dims(cfg)
    f32 = torch.float32
    # dt_bias = softplus^-1(dt) for dt log-uniform in [1e-3, 1e-1]
    u = torch.empty((*lead, di), dtype=f32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    # S4D-real initialization for A
    a_init = torch.arange(1, N + 1, dtype=f32, device=device).expand(*lead, di, N)
    return {
        "norm": norm_init(d, cfg.norm, dtype, device, lead),
        "w_in": dense_init(gen, d, 2 * di, dtype, device, lead=lead),
        "conv": _conv_init(gen, _mc(cfg).d_conv, di, dtype, device, lead),
        "w_xdbc": dense_init(gen, di, dtr + 2 * N, dtype, device, lead=lead),
        "w_dt": dense_init(gen, dtr, di, f32, device, lead=lead),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "log_a": torch.log(a_init),
        "d_skip": torch.ones((*lead, di), dtype=f32, device=device),
        "w_out": dense_init(gen, di, d, dtype, device, lead=lead),
    }


def _ssm_inputs(p: Params, cfg: ArchConfig, xc: torch.Tensor):
    """xc (B, T, di) -> dt (B, T, di) fp32, B (B, T, N), C (B, T, N) in xc's dtype."""
    _, N, dtr = _dims(cfg)
    xdbc = dense(p["w_xdbc"], xc)
    dt_in, Bm, Cm = torch.split(xdbc, [dtr, N, N], dim=-1)
    # F.softplus switches to the identity above 20, where it differs from
    # log(1 + e^x) by less than 3e-9
    dt = F.softplus(torch.matmul(dt_in.float(), p["w_dt"]) + p["dt_bias"])
    return dt, Bm, Cm


def mamba_apply(
    p: Params, cfg: ArchConfig, x: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    h = apply_norm(p["norm"], x, cfg.norm)
    xin, z = torch.chunk(dense(p["w_in"], h), 2, dim=-1)
    xc = F.silu(_causal_conv(p["conv"], xin))
    dt, Bm, Cm = _ssm_inputs(p, cfg, xc)
    A = -torch.exp(p["log_a"])  # (di, N) fp32
    # dt is rounded to xc's dtype before the scan, as in the reference
    y = ops.mamba_scan(xc, dt.to(xc.dtype), A, Bm, Cm, p["d_skip"], impl=impl)
    y = y * F.silu(z)
    return x + dense(p["w_out"], y)


def mamba_state_init(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device, lead: Sequence[int] = ()
) -> Dict[str, torch.Tensor]:
    di, N, _ = _dims(cfg)
    return {
        "h": torch.zeros((*lead, batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, _mc(cfg).d_conv - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(
    p: Params, cfg: ArchConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step on x (B, 1, d); the state is updated in place and returned.

    The conv window is computed in fp32 here, unlike the forward's conv, as in
    the reference.
    """
    h = apply_norm(p["norm"], x, cfg.norm)
    xin, z = torch.chunk(dense(p["w_in"], h), 2, dim=-1)  # (B, 1, di)
    xc, window = _conv_step(p["conv"], state["conv"], xin)
    dt, Bm, Cm = _ssm_inputs(p, cfg, xc)  # (B, 1, di) (B, 1, N) (B, 1, N)
    A = -torch.exp(p["log_a"])
    dtf = dt[:, 0].float()  # (B, di)
    dA = torch.exp(dtf[..., None] * A[None])  # (B, di, N)
    dBx = (dtf * xc[:, 0].float())[..., None] * Bm[:, 0].float()[:, None, :]
    h_new = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h_new, Cm[:, 0].float())
    y = y + p["d_skip"][None] * xc[:, 0].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    state["h"].copy_(h_new)
    state["conv"].copy_(window)
    return x + dense(p["w_out"], y), state
