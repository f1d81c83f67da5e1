"""Wrapper of the hand-written Hopper selective-scan kernel ``csrc/mamba_scan.cu``.

Counterpart of ``repro.kernels.mamba_scan.mamba_scan`` (the Pallas TPU
kernel); same arguments and semantics as
:func:`repro_torch.kernels.ref.mamba_scan_ref`. x, dt and the output share one
type (float32 or bfloat16), B and C one type of their own, A and D are
float32. Rows of every input may be strided (B and C are slices of one
projection in the mamba mixer); ragged T and Di are masked in the kernel.

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.mamba_scan``'s choice
of the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["mamba_scan", "LAUNCHES", "MAX_STATES"]

#: launches of the kernel in this process (incremented once per launch)
LAUNCHES = 0

#: the most states N a channel may have: 4 lanes of a warp hold at most 16 each
MAX_STATES = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535  # grid.y limit

_fn = None


def _forward_fn():
    global _fn
    if _fn is None:
        _fn = _build.load("mamba_scan").ms_forward
        _fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
                        + [ctypes.c_void_p])
        _fn.restype = ctypes.c_int
    return _fn


def _check(x, dt, A, B, C, D) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"mamba_scan: {name} lies on {t.device}, not on a CUDA device")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("mamba_scan: inputs must lie on one device")
    if x.dim() != 3:
        raise ValueError(f"mamba_scan: x must be (B, T, Di), got {tuple(x.shape)}")
    Bsz, T, Di = x.shape
    N = A.shape[-1]
    shapes = {"dt": (dt, (Bsz, T, Di)), "A": (A, (Di, N)), "B": (B, (Bsz, T, N)),
              "C": (C, (Bsz, T, N)), "D": (D, (Di,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"mamba_scan: {name} is {tuple(t.shape)}, expected {want}")
    if x.dtype not in _DTYPE_CODES or dt.dtype != x.dtype:
        raise TypeError(f"mamba_scan: x and dt are {x.dtype}, {dt.dtype}; the kernel takes one "
                        "of float32, bfloat16 for both")
    if B.dtype not in _DTYPE_CODES or C.dtype != B.dtype:
        raise TypeError(f"mamba_scan: B and C are {B.dtype}, {C.dtype}; the kernel takes one "
                        "of float32, bfloat16 for both")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"mamba_scan: A and D must be float32, got {A.dtype}, {D.dtype}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"mamba_scan: {name} rows must be contiguous, got strides {t.stride()}")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("mamba_scan: A and D must be contiguous")
    if not 1 <= N <= MAX_STATES:
        raise ValueError(f"mamba_scan: N={N} states; the kernel takes 1 to {MAX_STATES}")
    if Bsz > _MAX_BATCH:
        raise ValueError(f"mamba_scan: batch {Bsz} exceeds {_MAX_BATCH}")


def mamba_scan(
    x: torch.Tensor,  # (B, T, Di)
    dt: torch.Tensor,  # (B, T, Di), post-softplus
    A: torch.Tensor,  # (Di, N) fp32
    B: torch.Tensor,  # (B, T, N)
    C: torch.Tensor,  # (B, T, N)
    D: torch.Tensor,  # (Di,) fp32
) -> torch.Tensor:
    """Selective scan on the card; see :func:`repro_torch.kernels.ref.mamba_scan_ref`."""
    global LAUNCHES
    _check(x, dt, A, B, C, D)
    Bsz, T, Di = x.shape
    y = torch.empty((Bsz, T, Di), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _forward_fn()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[B.dtype],
            Bsz, T, Di, A.shape[-1],
            *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2], *C.stride()[:2],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return y
