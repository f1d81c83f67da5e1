"""Wrapper of the hand-written Hopper flash-attention kernel ``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the Pallas
TPU kernel); same arguments and semantics as
:func:`repro_torch.kernels.ref.attention_ref`. The kernel takes the
``(B, S, H, D)`` layout as strided rows, so no transposed copy is made; the
ragged last q and kv tiles are masked in the kernel, so any ``Sq``/``Sk`` work.

The input type picks the route (:func:`plan`): bf16 runs on the tensor cores
(``wgmma``, K and V fed by TMA into a ring of shared-memory tiles), fp32 on
the CUDA cores in fp32 FMAs. Both count in :data:`LAUNCHES`. A head dim
without a tile of its own runs in the next tile up (:func:`tile_dim`): the
columns past it load as zeros and are not stored.

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.attention``'s choice of
the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "plan", "smem_bytes", "tile_dim", "LAUNCHES", "HEAD_DIMS", "Plan", "TensorMap"]

#: launches of the kernel in this process, both routes (incremented once per launch)
LAUNCHES = 0

#: head dims the kernel takes, on both routes
HEAD_DIMS = (64, 80, 96, 128, 192, 256)
# the tile D that carries each head dim: bf16 (wgmma) route, fp32 route
_TILE_D = {
    torch.bfloat16: {64: 64, 80: 128, 96: 128, 128: 128, 192: 256, 256: 256},
    torch.float32: {64: 64, 80: 128, 96: 128, 128: 128, 192: 192, 256: 256},
}
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BH = 65535  # fp32 route: grid.y limit, B * Hq blocks
_MAX_QTILES = 65535  # bf16 route: grid.y limit, q tiles of a sequence
_TMA_ERR = 10000  # the bf16 entry returns this plus the CUresult of a refused tensor map

#: the bf16 route's q tile (two warpgroups of 64 rows) and TMA box width (one
#: 128-byte swizzle row of bf16)
BLOCK_Q = 128
BOX_COLS = 64

_fns = {}


def _kernel(name: str):
    if name not in _fns:
        fn = getattr(_build.load("flash_attention"), name)
        if name == "fa_forward_f32":
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
            )
        else:
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
            )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def tile_dim(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The head dim of the kernel's tile that carries ``head_dim`` on
    ``dtype``'s route: its own where there is one, else the next up (80 and
    96 in 128 on both routes; 192 in 256 on the bf16 route)."""
    return _TILE_D[dtype][head_dim]


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block of the kernel at this head dim on
    ``dtype``'s route."""
    fn = _build.load("flash_attention").fa_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(head_dim, int(dtype == torch.bfloat16))


def block_k(head_dim: int) -> int:
    """Keys per K/V tile of the bf16 route: 128 in the D 128 tile; 64 in the
    D 256 tile (shared memory) and the D 64 tile (registers: two blocks share
    an SM there)."""
    return 128 if tile_dim(head_dim) == 128 else 64


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """The TMA tensor map of one ``(B, S, H, D)`` bf16 operand.

    ``dims`` innermost first: the real head dim D (TMA fills a box's columns
    past it with zeros), then the head, row and batch axes in order of
    increasing stride (an axis of extent 1 goes last); ``strides`` in bytes, of
    dims 1..3; ``box`` the tile one load copies (64 columns, ``rows`` rows);
    ``slots`` the dim (1..3) that holds the head, the row and the batch axis.
    """

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    slots: Tuple[int, int, int]

    def flat(self) -> Tuple[int, ...]:
        """The 14 numbers the kernel's entry point reads for this operand."""
        return (*self.dims, *self.strides, *self.box, *self.slots)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a launch runs: the route (``"wgmma"`` for bf16, ``"fp32"``), its
    q and kv tile rows, the head dim and the tile's D that carries it, and on
    the bf16 route the tensor maps of q, k, v."""

    route: str
    block_q: int
    block_k: int
    head_dim: int
    tile_d: int
    maps: Tuple[TensorMap, ...] = ()


def _tensor_map(name, shape, stride, size, misalign, rows, kernel="flash_attention") -> TensorMap:
    """The tensor map of a ``(B, S, H, D)`` tensor of this shape, element
    stride and element size, ``misalign`` bytes past a 16-byte boundary, for
    boxes of ``rows`` rows; raises (naming ``kernel``) where TMA cannot read it."""
    B, S, H, D = shape
    if misalign:
        raise ValueError(
            f"{kernel}: {name} starts {misalign} bytes past a 16-byte boundary; "
            "the bf16 route loads it by TMA, which needs a 16-byte-aligned base"
        )
    axes = [("head", H, stride[2] * size), ("row", S, stride[1] * size), ("batch", B, stride[0] * size)]
    for axis, extent, step in axes:
        if extent > 1 and (step <= 0 or step % 16 or step >= 1 << 40):
            raise ValueError(
                f"{kernel}: {name}'s {axis} stride is {step} bytes; the bf16 route loads "
                "it by TMA, which needs a positive multiple of 16 bytes below 2^40"
            )
    # an axis of extent 1 is never stepped: put it outermost, with a stride past the others
    real = sorted((a for a in axes if a[1] > 1), key=lambda a: a[2])
    top = max([D * size] + [extent * step for _, extent, step in real])
    order = real + [(axis, extent, top) for axis, extent, _ in axes if extent <= 1]
    names = [axis for axis, _, _ in order]
    return TensorMap(
        dims=(D, *(extent for _, extent, _ in order)),
        strides=tuple(step for _, _, step in order),
        box=(BOX_COLS, *(rows if axis == "row" else 1 for axis in names)),
        slots=tuple(1 + names.index(axis) for axis in ("head", "row", "batch")),
    )


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The launch's route and tiles for these inputs (no card needed); raises
    on a bf16 layout the route cannot load. Plans are cached by the inputs'
    shapes, strides and alignment, which is all they depend on."""
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in {HEAD_DIMS}")
    if q.dtype == torch.float32:
        return Plan("fp32", 64, 64, q.shape[3], tile_dim(q.shape[3], q.dtype))
    return _bf16_plan(*((tuple(t.shape), t.stride(), t.element_size(), t.data_ptr() % 16) for t in (q, k, v)))


@functools.lru_cache(maxsize=256)
def _bf16_plan(q_meta, k_meta, v_meta) -> Plan:
    D = q_meta[0][3]
    bk = block_k(D)
    return Plan("wgmma", BLOCK_Q, bk, D, tile_dim(D), (
        _tensor_map("q", *q_meta, BLOCK_Q), _tensor_map("k", *k_meta, bk), _tensor_map("v", *v_meta, bk)))


@functools.lru_cache(maxsize=256)
def _plan_array(p: Plan) -> ctypes.Array:
    """The 42 numbers of a bf16 plan as the C array the kernel's entry point reads."""
    flat = [x for m in p.maps for x in m.flat()]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} lies on {t.device}, not on a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, D), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel takes float32, bfloat16")
        if t.dtype == torch.float32 and (t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3])):
            raise ValueError(
                f"flash_attention: {name} rows must be contiguous with strides a multiple of 4, "
                f"got strides {t.stride()}"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} rows must be contiguous, got strides {t.stride()}")
        if t.dtype == torch.float32 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not aligned to 16 bytes")
    if len({q.device, k.device, v.device}) != 1 or len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("flash_attention: q, k, v must share one device and one dtype")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype == torch.float32 and B * Hq > _MAX_BH:
        raise ValueError(f"flash_attention: B*Hq={B * Hq} exceeds {_MAX_BH}")
    if q.dtype == torch.bfloat16 and -(-Sq // BLOCK_Q) > _MAX_QTILES:
        raise ValueError(f"flash_attention: Sq={Sq} exceeds {_MAX_QTILES} tiles of {BLOCK_Q}")


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
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    if q.dtype == torch.bfloat16 and scale is not None and not scale > 0:
        raise ValueError(f"flash_attention: the bf16 route takes a scale > 0, got {scale}")
    p = plan(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        return out.zero_()
    _launch(q, k, v, out, p, causal=causal, window=window, softcap=softcap, q_offset=q_offset, scale=scale)
    return out


def _launch(q, k, v, out, p: Plan, *, causal, window, softcap, q_offset, scale) -> None:
    """Launches the kernel on checked inputs into ``out``, a contiguous
    ``(B, Sq, Hq, D)`` tensor of q's type on q's card, which it writes and
    nothing around it."""
    global LAUNCHES
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    mask = (int(causal), window or 0, q_offset,
            scale if scale is not None else 1.0 / math.sqrt(D), softcap or 0.0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, Hq, Hkv, D)
        if p.route == "fp32":
            err = _kernel("fa_forward_f32")(
                *ptrs, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *mask, stream)
        else:
            err = _kernel("fa_forward_bf16")(*ptrs, _plan_array(p), *mask, stream)
    if err >= _TMA_ERR:
        raise RuntimeError(f"flash_attention: the CUDA driver refused a TMA tensor map (CUresult {err - _TMA_ERR})")
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
