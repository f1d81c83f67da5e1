"""Wrapper of the hand-written Hopper chunkwise mLSTM kernel ``csrc/mlstm.cu``.

Counterpart of ``repro.kernels.mlstm.mlstm_chunkwise`` (the Pallas TPU
kernel); same arguments and semantics as
:func:`repro_torch.kernels.ref.mlstm_chunkwise_ref`. q, k, v and the output
share one type (float32 or bfloat16), the gates are float32. Rows of D must be
contiguous; the batch, time and head axes may be strided (the mLSTM block
hands over reshaped views of its projections). Ragged T is masked in the
kernel, which chooses its own chunk length (:data:`CHUNK`).

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.mlstm``'s choice of
the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["mlstm_chunkwise", "LAUNCHES", "CHUNK"]

#: calls of the op that launched the kernel in this process (one per call)
LAUNCHES = 0

#: the kernel's chunk length (``ml_chunk()`` of ``csrc/mlstm.cu``)
CHUNK = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535  # grid.y / grid.z limit: B * H sequences, T / CHUNK chunks

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("mlstm")
        lib.ml_chunk.argtypes, lib.ml_chunk.restype = [], ctypes.c_int
        if lib.ml_chunk() != CHUNK:
            raise RuntimeError(f"mlstm: the kernel's chunk is {lib.ml_chunk()}, not {CHUNK}")
        lib.ml_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.ml_workspace_floats.restype = ctypes.c_longlong
        lib.ml_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                   + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.ml_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, i_gate, f_gate) -> None:
    named = (("q", q), ("k", k), ("v", v), ("i_gate", i_gate), ("f_gate", f_gate))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"mlstm: {name} lies on {t.device}, not on a CUDA device")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("mlstm: inputs must lie on one device")
    if q.dim() != 4:
        raise ValueError(f"mlstm: q must be (B, T, H, D), got {tuple(q.shape)}")
    B, T, H, _ = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"mlstm: {name} is {tuple(t.shape)}, expected {tuple(q.shape)}")
    for name, t in (("i_gate", i_gate), ("f_gate", f_gate)):
        if tuple(t.shape) != (B, T, H):
            raise ValueError(f"mlstm: {name} is {tuple(t.shape)}, expected {(B, T, H)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mlstm: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the kernel takes "
                        "one of float32, bfloat16 for all three")
    if i_gate.dtype != torch.float32 or f_gate.dtype != torch.float32:
        raise TypeError(f"mlstm: the gates must be float32, got {i_gate.dtype}, {f_gate.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"mlstm: {name} rows must be contiguous, got strides {t.stride()}")
    if B * H > _MAX_GRID or -(-T // CHUNK) > _MAX_GRID:
        raise ValueError(f"mlstm: B*H={B * H} sequences or {-(-T // CHUNK)} chunks exceed {_MAX_GRID}")


def mlstm_chunkwise(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, T, H) fp32
    f_gate: torch.Tensor,  # (B, T, H) fp32
) -> torch.Tensor:
    """Chunkwise mLSTM on the card; see :func:`repro_torch.kernels.ref.mlstm_chunkwise_ref`."""
    global LAUNCHES
    _check(q, k, v, i_gate, f_gate)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    work = torch.empty(lib.ml_workspace_floats(B, T, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ml_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
            out.data_ptr(), work.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *i_gate.stride(), *f_gate.stride(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mlstm: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
