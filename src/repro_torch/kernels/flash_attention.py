"""Wrapper of the hand-written Hopper flash-attention kernel ``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the Pallas
TPU kernel); same arguments and semantics as
:func:`repro_torch.kernels.ref.attention_ref`. The kernel takes the
``(B, S, H, D)`` layout as strided rows, so no transposed copy is made; the
ragged last q and kv tiles are masked in the kernel, so any ``Sq``/``Sk`` work.

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.attention``'s choice of
the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "smem_bytes", "LAUNCHES", "HEAD_DIMS"]

#: launches of the kernel in this process (incremented once per launch)
LAUNCHES = 0

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # grid.y limit: B * Hq blocks

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").fa_forward
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 9
            + [ctypes.c_int] * 3
            + [ctypes.c_float] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the kernel at this head dim."""
    fn = _build.load("flash_attention").fa_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(head_dim)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} lies on {t.device}, not on a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, D), got {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel takes float32, bfloat16")
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention: {name} rows must be contiguous with strides a multiple of 4, "
                f"got strides {t.stride()}"
            )
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"flash_attention: {name} is not aligned to {4 * t.element_size()} bytes")
    if len({q.device, k.device, v.device}) != 1 or len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("flash_attention: q, k, v must share one device and one dtype")
    B, _, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if B * Hq > _MAX_BH:
        raise ValueError(f"flash_attention: B*Hq={B * Hq} exceeds {_MAX_BH}")


def flash_attention(
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
    """Flash attention on the card; see :func:`repro_torch.kernels.ref.attention_ref`."""
    global LAUNCHES
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, q_offset,
            scale if scale is not None else 1.0 / math.sqrt(D), softcap or 0.0,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
