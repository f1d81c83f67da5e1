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

The inputs pick the route (:func:`plan`): bf16 with row blocks of more than
16 rows (the prefill products) runs on ``wgmma`` with lhs and rhs fed by TMA
into a ring of shared-memory tiles and the output stored by TMA, in a
persistent schedule; bf16 with row
blocks of at most 16 rows (the decode step) on ``mma.sync`` tiles of 16 rows;
fp32 on the CUDA cores (no TF32). All count in :data:`LAUNCHES`.

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.gmm``'s choice of the
plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["gmm", "plan", "LAUNCHES", "Plan", "TensorMap"]

#: launches of the kernel in this process (incremented once per launch)
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 2**31 - 1
_TMA_ERR = 10000  # the entry returns this plus the CUresult of a refused tensor map

#: bf16 row blocks of at most this many rows take the small mma.sync tile
SMALL_BLOCK_M = 16
#: the wgmma route's output tile (two warpgroups of 64 rows) and K step (one
#: 128-byte swizzle row of bf16, the width of every TMA box)
TILE_M, TILE_N, BLOCK_K = 128, 256, 64

_fn = None


def _forward_fn():
    global _fn  # lint: waive[JP001] one-time lazy load of the built library; idempotent
    if _fn is None:
        _fn = _build.load("gmm").gmm_forward
        _fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        _fn.restype = ctypes.c_int
    return _fn


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """The TMA tensor map of a contiguous operand as a 4-D tensor: ``dims``
    innermost first (axes of extent 1 pad it to four), ``strides`` in bytes
    of dims 1..3, ``box`` the tile one load or store copies."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]

    def flat(self) -> Tuple[int, ...]:
        """The 11 numbers the kernel's entry point reads for this operand."""
        return (*self.dims, *self.strides, *self.box)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a launch runs: the route (``"wgmma"``, ``"mma_sync"`` or
    ``"fp32"``), the row block, the output tile, and on the wgmma route the
    tensor maps of lhs, as (K, M), of rhs, as (N, K, G), and of the output, as
    (N, block_m, M / block_m): its stores stop at the end of a row block."""

    route: str
    block_m: int
    tile_m: int
    tile_n: int
    maps: Tuple[TensorMap, ...] = ()


def _map(dims, box, size=2) -> TensorMap:
    """The map of a contiguous tensor of these dims (innermost first) and
    element size; an axis of extent 1 pads the rank to four, at the tensor's
    whole span."""
    strides, step = [], size
    for extent in dims[:-1]:
        step *= extent
        strides.append(step)
    span = step * dims[-1]
    pad = 4 - len(dims)
    return TensorMap(dims=(*dims, *[1] * pad), strides=(*strides, *[span] * pad),
                     box=(*box, *[1] * (4 - len(box))))


def plan(lhs: torch.Tensor, rhs: torch.Tensor, group_ids: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> Plan:
    """The launch's route, tile and tensor maps for these inputs and output
    type (lhs's by default); no card needed: they depend on the shapes and
    the types alone."""
    return _plan(tuple(lhs.shape), tuple(rhs.shape), group_ids.shape[0], lhs.dtype, out_dtype or lhs.dtype)


@functools.lru_cache(maxsize=256)
def _plan(lhs_shape, rhs_shape, n_blocks, dtype: torch.dtype, out_dtype: torch.dtype) -> Plan:
    (M, K), (G, _, N) = lhs_shape, rhs_shape
    block_m = M // n_blocks
    if dtype == torch.float32:
        return Plan("fp32", block_m, 64, 64)
    if block_m <= SMALL_BLOCK_M:
        return Plan("mma_sync", block_m, 16, 64)
    size = torch.finfo(out_dtype).bits // 8
    # a store box is one 128-byte swizzle row wide, a warpgroup's 64 rows high
    return Plan("wgmma", block_m, TILE_M, TILE_N, (
        _map((K, M), (BLOCK_K, TILE_M)), _map((N, K, G), (64, BLOCK_K)),
        _map((N, block_m, n_blocks), (128 // size, 64), size)))


@functools.lru_cache(maxsize=256)
def _plan_array(p: Plan) -> ctypes.Array:
    """The 33 numbers of a wgmma plan as the C array the kernel's entry point reads."""
    flat = [x for m in p.maps for x in m.flat()]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(lhs, rhs, group_ids, out_dtype: torch.dtype) -> None:
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
    # LAUNCHES counts the launches this wrapper issues: a recompute launches again
    # and counts; a graph replay launches without the wrapper and does not.
    global LAUNCHES  # lint: waive[JP001] host count of this wrapper's launches (see above)
    out_dtype = lhs.dtype if out_dtype is None else out_dtype
    _check(lhs, rhs, group_ids, out_dtype)
    M, K = lhs.shape
    G, _, N = rhs.shape
    out = torch.empty((M, N), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    p = plan(lhs, rhs, group_ids, out_dtype)
    fn = _forward_fn()
    with torch.cuda.device(lhs.device):
        err = fn(
            lhs.data_ptr(), rhs.data_ptr(), group_ids.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[lhs.dtype], _DTYPE_CODES[out_dtype], M, K, N, G, p.block_m,
            _plan_array(p) if p.maps else None, torch.cuda.current_stream(lhs.device).cuda_stream,
        )
    if err >= _TMA_ERR:
        raise RuntimeError(f"gmm: the CUDA driver refused a TMA tensor map (CUresult {err - _TMA_ERR})")
    if err != 0:
        raise RuntimeError(f"gmm: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
