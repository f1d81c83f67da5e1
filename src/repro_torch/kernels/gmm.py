"""Wrapper of the hand-written Hopper grouped matrix product ``csrc/gmm.cu``.

Counterpart of ``repro.kernels.gmm.gmm`` (the Pallas TPU kernel): rows of
``lhs`` (M, K) are sorted by group, every run of ``block_m = M /
len(group_ids)`` rows belongs to group ``group_ids[i]``, and each row is
multiplied by its group's matrix of ``rhs`` (G, K, N), summed in fp32. The
output is ``lhs``'s type, as the TPU kernel's, or float32 on request
(``out_dtype``), rounded once from the fp32 sums. ``block_m`` may be any
divisor of M, 1 included (a decode step's one copy per expert). Same
function as :func:`repro_torch.kernels.ref.gmm_ref` with every group
``block_m`` rows long per id.

bf16 inputs run on the tensor cores (``mma.sync``), fp32 inputs on the CUDA
cores (no TF32). This wrapper only launches: a tensor that is not on a card,
or anything else the kernel does not take, raises. The CPU path is
``ops.gmm``'s choice of the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["gmm", "LAUNCHES"]

#: launches of the kernel in this process (incremented once per launch)
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 2**31 - 1

_fn = None


def _forward_fn():
    global _fn
    if _fn is None:
        _fn = _build.load("gmm").gmm_forward
        _fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        _fn.restype = ctypes.c_int
    return _fn


def _check(lhs, rhs, group_ids, out_dtype) -> None:
    named = (("lhs", lhs), ("rhs", rhs), ("group_ids", group_ids))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"gmm: {name} lies on {t.device}, not on a CUDA device")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("gmm: inputs must lie on one device")
    if lhs.dim() != 2 or rhs.dim() != 3 or group_ids.dim() != 1:
        raise ValueError(f"gmm: lhs must be (M, K), rhs (G, K, N), group_ids (M / block_m,); got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, {tuple(group_ids.shape)}")
    M, K = lhs.shape
    G, K2, N = rhs.shape
    if K2 != K:
        raise ValueError(f"gmm: lhs has K={K}, rhs has K={K2}")
    n_blocks = group_ids.shape[0]
    if n_blocks == 0 or M % n_blocks:
        raise ValueError(f"gmm: {n_blocks} group ids do not cut M={M} into equal row blocks")
    if lhs.dtype not in _DTYPE_CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"gmm: lhs and rhs are {lhs.dtype}, {rhs.dtype}; the kernel takes one of "
                        "float32, bfloat16 for both")
    if out_dtype not in (lhs.dtype, torch.float32):
        raise TypeError(f"gmm: out_dtype {out_dtype}; the kernel writes {lhs.dtype} or float32")
    if group_ids.dtype != torch.int32:
        raise TypeError(f"gmm: group_ids must be int32, got {group_ids.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"gmm: {name} must be contiguous, got strides {t.stride()}")
    if max(M, K, N, G) > _MAX_DIM:
        raise ValueError(f"gmm: a dimension of {(M, K, N, G)} exceeds {_MAX_DIM}")
    if lhs.dtype == torch.bfloat16:
        if K % 8 or N % 8:
            raise ValueError(f"gmm: bf16 needs K and N multiples of 8 (16-byte rows), got {K}, {N}")
        if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
            raise ValueError("gmm: bf16 lhs and rhs must start on a 16-byte boundary")


def gmm(
    lhs: torch.Tensor,  # (M, K), rows sorted by group
    rhs: torch.Tensor,  # (G, K, N)
    group_ids: torch.Tensor,  # (M / block_m,) int32: the group of each row block
    *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped matrix product on the card; see :func:`repro_torch.kernels.ref.gmm_ref`.

    A group id outside [0, G) is the caller's error; its rows come out NaN.
    """
    global LAUNCHES
    out_dtype = lhs.dtype if out_dtype is None else out_dtype
    _check(lhs, rhs, group_ids, out_dtype)
    M, K = lhs.shape
    G, _, N = rhs.shape
    out = torch.empty((M, N), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    fn = _forward_fn()
    with torch.cuda.device(lhs.device):
        err = fn(
            lhs.data_ptr(), rhs.data_ptr(), group_ids.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[lhs.dtype], _DTYPE_CODES[out_dtype], M, K, N, G, M // group_ids.shape[0],
            torch.cuda.current_stream(lhs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gmm: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
