"""Plain PyTorch versions of the port's kernels (counterpart of ``repro.kernels.ref``).

These are the reference semantics: each CUDA kernel must match its plain
version to float tolerance, and they are the CPU execution path of the model
substrate (``ops.attention`` picks them for CPU tensors).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref", "mamba_scan_ref"]


def _attn_mask(
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Boolean mask (Sq, Sk): True = attend."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return ok


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention with optional causal/sliding-window mask and softcap.

    ``q_offset`` places the query block at absolute positions
    ``[q_offset, q_offset + Sq)`` against keys at ``[0, Sk)``. Math in fp32,
    output in ``q.dtype``; rows with no key to attend return 0, not NaN.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = _attn_mask(q_pos, k_pos, causal, window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (can happen with tiny windows) -> zeros, not NaN
    probs = torch.where(mask.any(dim=-1)[:, None], probs, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def mamba_scan_ref(
    x: torch.Tensor,  # (B, T, Di)
    dt: torch.Tensor,  # (B, T, Di), post-softplus
    A: torch.Tensor,  # (Di, N), negative (continuous time)
    B: torch.Tensor,  # (B, T, N)
    C: torch.Tensor,  # (B, T, N)
    D: torch.Tensor,  # (Di,)
) -> torch.Tensor:
    """Selective SSM scan (Mamba-1 semantics), sequential over T in fp32.

    ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``; ``y_t = C_t . h_t + D x_t``,
    with ``D x`` added in fp32 before the one cast to ``x.dtype``.
    """
    Bsz, T, Di = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B.float(), C.float(), A.float()
    h = torch.zeros((Bsz, Di, A.shape[1]), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bsz, T, Di), dtype=torch.float32, device=x.device)
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])  # (B, Di, N)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    return (ys + xf * D.float()).to(x.dtype)
