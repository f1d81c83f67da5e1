"""Dispatch each op to its CUDA kernel or its plain version (``repro.kernels.ops``).

Dispatch policy (``impl``):
* ``"cuda"`` — the hand-written kernel; raises on tensors that are not on a card,
* ``"ref"``  — the plain PyTorch version (:mod:`repro_torch.kernels.ref`),
* ``"auto"`` — ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU tensors.

There is no fallback: a CUDA tensor under ``"auto"`` launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan as mamba_scan_kernel
from repro_torch.kernels.mlstm import mlstm_chunkwise
from repro_torch.kernels.ref import attention_ref, mamba_scan_ref, mlstm_chunked_scan

__all__ = ["attention", "mamba_scan", "mlstm", "resolve_impl"]

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if x.is_cuda else "ref"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    fn = flash_attention if resolve_impl(impl, q) == "cuda" else attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset)


def mamba_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    fn = mamba_scan_kernel if resolve_impl(impl, x) == "cuda" else mamba_scan_ref
    return fn(x, dt, A, B, C, D)


def mlstm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,
    f_gate: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunkwise mLSTM. ``"ref"`` is the chunked scan with ``chunk=min(256, T)``,
    as the reference's ``"ref"`` (T must be a multiple of it); the kernel
    takes its own chunk length and any T."""
    if resolve_impl(impl, q) == "cuda":
        return mlstm_chunkwise(q, k, v, i_gate, f_gate)
    return mlstm_chunked_scan(q, k, v, i_gate, f_gate, chunk=min(256, q.shape[1]))
