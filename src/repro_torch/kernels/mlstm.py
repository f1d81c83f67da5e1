"""Wrapper of the hand-written Hopper chunkwise mLSTM kernel ``csrc/mlstm.cu``.

Counterpart of ``repro.kernels.mlstm.mlstm_chunkwise`` (the Pallas TPU
kernel); same arguments and semantics as
:func:`repro_torch.kernels.ref.mlstm_chunkwise_ref`. q, k, v and the output
share one type (float32 or bfloat16), the gates are float32. Rows of D must be
contiguous; the batch, time and head axes may be strided (the mLSTM block
hands over reshaped views of its projections). Ragged T is masked in the
kernel, which chooses its own chunk length (:func:`plan`).

The inputs pick the route (:func:`plan`), by shape: bf16 with ``D % 64 == 0``
and ``D <= 512`` runs on the tensor cores (``wgmma``, q, k, v and the state
fed by TMA, chunk :data:`WGMMA_CHUNK`), with every fp32 operand of a
numerator product split into a bf16 hi and lo pair
(:func:`repro_torch.kernels.ref.mlstm_rounded_scan` models its arithmetic);
every other bf16 D and all of fp32 run on the CUDA cores in
fp32 FMAs (chunk :data:`CHUNK`). Both count in :data:`LAUNCHES`.

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.mlstm``'s choice of
the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import BOX_COLS, TensorMap, _tensor_map

__all__ = ["mlstm_chunkwise", "plan", "LAUNCHES", "CHUNK", "WGMMA_CHUNK", "Plan"]

#: calls of the op that launched the kernel in this process (one per call, both routes)
LAUNCHES = 0

#: the CUDA-core route's chunk length (``ml_chunk()`` of ``csrc/mlstm.cu``)
CHUNK = 64
#: the wgmma route's chunk length (``ml_wgmma_chunk()``): two warpgroups of 64 rows
WGMMA_CHUNK = 128
#: head dims the wgmma route takes: multiples of 64 up to this (q stays in shared memory)
WGMMA_MAX_D = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535  # grid.y / grid.z limit: B * H sequences, chunks
_TMA_ERR = 10000  # the bf16 entry returns this plus the CUresult of a refused tensor map

# the wgmma route's shared memory (csrc/mlstm.cu, namespace wg): a TMA box of
# q, k or v is 64 columns x 128 rows of bf16; the states pass holds a 2-deep
# ring of k and v (two boxes each), per consumer warpgroup a staging buffer
# for the state's store (hi and lo, 64 x 128 each) and two chunks' key
# weights, and its barriers; the output pass q (D / 64 boxes), a 3-deep ring of two-box
# stages, its barriers and the chunk's column keys; 1024 bytes of each are
# slack to align the tiles to the swizzle atom
_BOX_BYTES = WGMMA_CHUNK * BOX_COLS * 2
_STATES_SMEM = 1024 + 2 * 4 * _BOX_BYTES + 2 * 4 * 64 * 64 * 2 + 2 * 2 * WGMMA_CHUNK * 4 + 16 * 2
#: a block's shared-memory limit on Hopper (227 KB)
SMEM_LIMIT = 232448


def _output_smem(D: int) -> int:
    return 1024 + (D // 64) * _BOX_BYTES + 3 * 2 * _BOX_BYTES + 8 * (WGMMA_MAX_D // 64 + 6) + 4 * WGMMA_CHUNK


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a call launches: the route (``"wgmma"`` or ``"cuda_cores"``), its
    chunk length, each launch's grid (name, (x, y, z)) and dynamic shared
    memory (name, bytes), and on the wgmma route the tensor maps of q, k, v
    (``(B, T, H, D)``, boxes of 64 columns and one chunk of rows), of the
    state scratch (``(B * H * nc, 2 * nt, D, 128)`` bf16: hi and lo of each of
    the ``nt`` 128-column tiles of C, boxes of 64 x 64) and of the output
    (contiguous ``(B, T, H, D)``, boxes of 64 columns and 64 rows)."""

    route: str
    chunk: int
    grids: Tuple[Tuple[str, Tuple[int, int, int]], ...]
    smem: Tuple[Tuple[str, int], ...] = ()
    maps: Tuple[TensorMap, ...] = ()


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The call's route, chunk, grids, shared memory and tensor maps for these
    inputs (no card needed); raises on a bf16 layout the wgmma route cannot
    load, and on grids past the card's limits. Cached by the inputs' shapes,
    strides and alignment, which is all it depends on."""
    return _plan(*((tuple(t.shape), t.stride(), t.element_size(), t.data_ptr() % 16) for t in (q, k, v)),
                 q.dtype)


@functools.lru_cache(maxsize=256)
def _plan(q_meta, k_meta, v_meta, dtype) -> Plan:
    B, T, H, D = q_meta[0]
    BH = B * H
    if dtype == torch.bfloat16 and D % 64 == 0 and D <= WGMMA_MAX_D:
        L = WGMMA_CHUNK
        nc, nt = -(-T // L), -(-D // 128)
        _check_grid(BH, nc)
        grids = (("gates", (BH, 1, 1)),) + ((("states", (nt * nt, BH, 1)),) if nc > 1 else ()) + (
            ("output", (nc, BH, 1)),)
        # the state scratch (B*H*nc, 2*nt, D, 128): per hi and lo, each 128-column
        # tile of C as D rows of 256 bytes, so 64 rows of a tile are contiguous
        scratch = TensorMap(dims=(128, D, 2 * nt, BH * nc), strides=(256, 256 * D, 512 * nt * D),
                            box=(BOX_COLS, 64, 1, 1), slots=(0, 0, 0))
        maps = tuple(_tensor_map(name, *meta, L, kernel="mlstm")
                     for name, meta in (("q", q_meta), ("k", k_meta), ("v", v_meta)))
        # the output, contiguous, stored by TMA in boxes of a warpgroup's 64 rows
        out = _tensor_map("out", (B, T, H, D), (T * H * D, H * D, D, 1), 2, 0, 64, kernel="mlstm")
        return Plan("wgmma", L, grids, (("states", _STATES_SMEM), ("output", _output_smem(D))),
                    (*maps, scratch, out))
    L = CHUNK
    nc, nd = -(-T // L), -(-D // 64)
    _check_grid(BH, nc)
    return Plan("cuda_cores", L, (("gates", (BH, 1, 1)), ("states", (nd * nd, BH, 1)), ("scores", (nc, BH, 1)),
                                  ("output", (nd, nc, BH))))


def _check_grid(BH: int, nc: int) -> None:
    if BH > _MAX_GRID or nc > _MAX_GRID:
        raise ValueError(f"mlstm: B*H={BH} sequences or {nc} chunks exceed {_MAX_GRID}")


@functools.lru_cache(maxsize=256)
def _plan_array(p: Plan) -> ctypes.Array:
    """The 70 numbers of a wgmma plan as the C array the kernel's entry point reads."""
    flat = [x for m in p.maps for x in m.flat()]
    return (ctypes.c_longlong * len(flat))(*flat)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("mlstm")
        lib.ml_chunk.argtypes, lib.ml_chunk.restype = [], ctypes.c_int
        lib.ml_wgmma_chunk.argtypes, lib.ml_wgmma_chunk.restype = [], ctypes.c_int
        if (lib.ml_chunk(), lib.ml_wgmma_chunk()) != (CHUNK, WGMMA_CHUNK):
            raise RuntimeError(f"mlstm: the kernel's chunks are {lib.ml_chunk()}, {lib.ml_wgmma_chunk()}, "
                               f"not {CHUNK}, {WGMMA_CHUNK}")
        for name in ("ml_workspace_floats", "ml_wgmma_workspace_floats"):
            getattr(lib, name).argtypes = [ctypes.c_int] * 4
            getattr(lib, name).restype = ctypes.c_longlong
        lib.ml_wgmma_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ml_wgmma_smem_bytes.restype = ctypes.c_int
        lib.ml_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                   + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.ml_forward.restype = ctypes.c_int
        lib.ml_forward_bf16.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                                        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        lib.ml_forward_bf16.restype = ctypes.c_int
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
    p = plan(q, k, v)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    gates = (*i_gate.stride(), *f_gate.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if p.route == "wgmma":
            work = torch.empty(lib.ml_wgmma_workspace_floats(B, T, H, D), dtype=torch.float32, device=q.device)
            err = lib.ml_forward_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
                out.data_ptr(), work.data_ptr(), B, T, H, D, *gates, _plan_array(p), stream)
        else:
            work = torch.empty(lib.ml_workspace_floats(B, T, H, D), dtype=torch.float32, device=q.device)
            err = lib.ml_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
                out.data_ptr(), work.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *gates, stream)
    if err >= _TMA_ERR:
        raise RuntimeError(f"mlstm: cuTensorMapEncodeTiled refused a TMA tensor map (CUresult {err - _TMA_ERR})")
    if err != 0:
        raise RuntimeError(f"mlstm: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
