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
from repro_torch.kernels.ref import attention_ref

__all__ = ["attention", "resolve_impl"]

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
