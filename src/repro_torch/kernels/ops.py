"""Dispatch each op to its CUDA kernel or its plain version (``repro.kernels.ops``).

Dispatch policy (``impl``):
* ``"cuda"`` — the hand-written kernel; raises on tensors that are not on a card,
* ``"ref"``  — the plain PyTorch version (:mod:`repro_torch.kernels.ref`),
* ``"auto"`` — ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU tensors.

There is no fallback: a CUDA tensor under ``"auto"`` launches the kernel or
raises. On a mesh (a DTensor on the ambient mesh) the chosen route runs on
each rank's local shards (:mod:`repro_torch.distributed.parallel`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch

from repro_torch.distributed import parallel
from repro_torch.distributed.hints import active_mesh

from repro_torch.kernels.decode_attention import decode_attention as decode_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gmm import gmm as gmm_kernel
from repro_torch.kernels.mamba_scan import mamba_scan as mamba_scan_kernel
from repro_torch.kernels.mlstm import mlstm_chunkwise
from repro_torch.kernels.ref import (
    attention_ref,
    decode_attention_ref,
    gmm_ref,
    mamba_scan_ref,
    mlstm_chunked_scan,
)

__all__ = ["attention", "decode_attention", "gmm", "mamba_scan", "mlstm", "resolve_impl"]

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
    fn = functools.partial(flash_attention if resolve_impl(impl, q) == "cuda" else attention_ref,
                           causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return fn(q, k, v) if active_mesh(q) is None else parallel.attention(fn, q, k, v)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    fill_len: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """One query token a sequence against the slots ``[0, fill_len)`` of its
    KV cache. A cache on a mesh takes ``models.attention``'s plain split-K
    path, never this one."""
    fn = decode_attention_kernel if resolve_impl(impl, q) == "cuda" else decode_attention_ref
    return fn(q, k, v, fill_len)


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
    if active_mesh(x) is not None:
        return parallel.mamba_scan(fn, x, dt, A, B, C, D)
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
    # lint: waive[JP002] dispatch on impl and q's device: static under trace and capture
    if resolve_impl(impl, q) == "cuda":
        fn = mlstm_chunkwise
    else:
        fn = functools.partial(mlstm_chunked_scan, chunk=min(256, q.shape[1]))
    if active_mesh(q) is not None:
        return parallel.mlstm(fn, q, k, v, i_gate, f_gate)
    return fn(q, k, v, i_gate, f_gate)


def gmm(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_ids: torch.Tensor,
    group_sizes: Union[torch.Tensor, Sequence[int], None] = None,
    *,
    impl: str = "auto",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped matmul. ``"ref"`` needs ``group_sizes``, as the reference's
    ``"ref"``; the kernel takes the group of each row block (``group_ids``)."""
    # lint: waive[JP002] dispatch on impl and lhs's device: static under trace and capture
    if resolve_impl(impl, lhs) == "cuda":
        return gmm_kernel(lhs, rhs, group_ids, out_dtype=out_dtype)
    if group_sizes is None:
        raise ValueError("gmm: the plain version needs group_sizes")
    return gmm_ref(lhs, rhs, group_sizes, out_dtype=out_dtype)
