"""Wrapper of the hand-written Hopper decode attention ``csrc/decode_attention.cu`` (K5).

Replaces no TPU kernel: the JAX package's decode attention
(``repro.models.attention._decode_attention``) is an einsum over the whole
cache with no Pallas kernel behind it. Same function as
:func:`repro_torch.kernels.ref.decode_attention_ref`: one query token a
sequence, q ``(B, 1, Hq, D)``, against the slots ``[0, fill_len)`` of a cache
k, v ``(B, L, Hkv, D)``; scores ``q.k / sqrt(D)``, softmax and ``P.V`` in
fp32, the output ``(B, 1, Hq, D)`` in q's type. A sliding-window ring cache
passes ``fill_len = L`` once full, as the plain version does.

It is bound by the bytes of the cache's filled slots. The kernel reads each
filled K and V row once, in the cache's own type (bf16, or fp32 for fp32
caches), for all ``g = Hq / Hkv`` query heads of its kv head, and never reads
a slot past ``fill_len``; all arithmetic is fp32 on the CUDA cores. One block
per (split, kv head, sequence) walks its split's slots in tiles of
:data:`TILE` through a cp.async ring; :func:`plan` picks the splits from B *
Hkv, ``fill_len``, D, g and the cache's type, so that the blocks keep the
card's HBM busy (mixtral's 64 x 8 (sequence, head) pairs need none; one
sequence at 4,096 slots needs many). More than one split adds a second
launch that merges the splits' partial softmaxes in a fixed order (no
atomics: the same bits every run). The cache is read in place through its
strides (16-byte aligned rows; the last dim contiguous).

The mesh path (``repro_torch.distributed.parallel.decode_attention``, a
cache split over ranks) keeps its plain local function; this kernel runs
only where the cache lies whole on one card.

Each call records ``rt.attention.decode`` ``(fill_len, splits)`` for a
profiler (:mod:`repro_torch.obs`). This wrapper only launches: a tensor that
is not on a card, or anything else the kernel does not take, raises. The CPU
path is ``ops.decode_attention``'s choice of the plain version, never a
fallback here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict

import torch

from repro_torch import obs
from repro_torch.kernels import _build

__all__ = ["decode_attention", "plan", "Plan", "LAUNCHES", "TILE", "MAX_GROUP", "MAX_HEAD_DIM"]

#: launches of the kernels in this process: 1 a call, 2 with more than one split
LAUNCHES = 0

#: slots a tile (one warp's lanes), depth of the cp.async ring, threads a block
TILE, STAGES, THREADS = 32, 3, 128
#: the most query heads a kv head, and the largest head dim (a multiple of 8)
MAX_GROUP, MAX_HEAD_DIM = 16, 256
#: SMs of an H100, for a plan made without a card
H100_SMS = 132
#: bytes of K and V that each SM should keep in flight (a few times what
#: Little's law asks of 3.35 TB/s at HBM's latency)
BYTES_IN_FLIGHT = 64 * 1024
_SMEM_PER_SM = 233_472  # shared memory an SM gives its blocks (228 KB)
_SMEM_RESERVED = 1024  # shared memory the system reserves a block
_MAX_BLOCKS_PER_SM = 2048 // THREADS
_MAX_GRID_YZ = 65_535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a call launches: ``splits`` blocks of ``tiles_per_split`` tiles
    a (sequence, kv head) over the ``tiles`` tiles that hold the filled
    slots (only the last tile of the last split is ragged); ``blocks`` of
    ``smem_bytes`` dynamic shared memory each; ``launches``: 2 when the
    splits' fp32 partials are merged by a second launch."""

    splits: int
    tiles_per_split: int
    tiles: int
    blocks: int
    smem_bytes: int
    launches: int


def smem_bytes(kv_dtype: torch.dtype, head_dim: int, group: int) -> int:
    """A block's dynamic shared memory: the ring of K and V tiles (rows padded
    by 16 bytes), the g query rows in fp32, a tile's P, and each head's
    factor and sum."""
    size = torch.empty((), dtype=kv_dtype).element_size()
    row = head_dim + 16 // size
    return STAGES * 2 * TILE * row * size + 4 * (group * head_dim + group * (TILE + 1) + 2 * group)


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fill_len: int, sms: int = H100_SMS) -> Plan:
    """The call's splits and sizes for these inputs on a card of ``sms`` SMs
    (no card needed); raises on what the kernel does not take."""
    fill = _check_layout(q, k, v, fill_len)
    B, _, Hkv, D = k.shape
    return _plan(B, Hkv, q.shape[2] // Hkv, D, fill, k.dtype, sms)


@functools.lru_cache(maxsize=1024)
def _plan(B: int, Hkv: int, g: int, D: int, fill: int, kv_dtype: torch.dtype, sms: int) -> Plan:
    smem = smem_bytes(kv_dtype, D, g)
    resident = max(1, min(_MAX_BLOCKS_PER_SM, _SMEM_PER_SM // (smem + _SMEM_RESERVED)))
    in_flight = (STAGES - 1) * 2 * TILE * D * torch.empty((), dtype=kv_dtype).element_size()
    per_sm = min(resident, max(1, -(-BYTES_IN_FLIGHT // in_flight)))
    tiles = -(-fill // TILE)
    splits = min(tiles, max(1, -(-sms * per_sm // (B * Hkv))))
    per_split = -(-tiles // splits)
    splits = -(-tiles // per_split)
    return Plan(splits, per_split, tiles, B * Hkv * splits, smem, 1 if splits == 1 else 2)


def _check_layout(q, k, v, fill_len) -> int:
    """Raises on what the kernel does not take; returns ``fill_len`` as an int."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"decode_attention: k and v must be one (B, L, Hkv, D) shape, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, L, Hkv, D = k.shape
    Hq = q.shape[2]
    if q.shape[0] != B or q.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit the cache {tuple(k.shape)}")
    if not (Hq // Hkv <= MAX_GROUP and D % 8 == 0 and 8 <= D <= MAX_HEAD_DIM):
        raise ValueError(f"decode_attention: {Hq // Hkv} query heads a kv head and head dim {D}; the "
                         f"kernel takes up to {MAX_GROUP} heads and a multiple of 8 up to {MAX_HEAD_DIM}")
    if B > _MAX_GRID_YZ or Hkv > _MAX_GRID_YZ:
        raise ValueError(f"decode_attention: B {B} and Hkv {Hkv} must be at most {_MAX_GRID_YZ}")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the kernel "
                        "takes float32 or bfloat16 for q and one of them for both k and v")
    fill = fill_len if isinstance(fill_len, int) and not isinstance(fill_len, bool) else None
    if fill is None or not 1 <= fill <= L:
        raise ValueError(f"decode_attention: fill_len {fill_len!r} must be an int in [1, {L}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"decode_attention: {name} rows must be contiguous, got strides {t.stride()}")
    size = k.element_size()
    for name, t in (("k", k), ("v", v)):
        strides = [t.stride(i) * size for i in range(3) if t.shape[i] > 1]
        if t.data_ptr() % 16 or any(s % 16 for s in strides):
            raise ValueError(f"decode_attention: {name}'s rows must start on 16 bytes (cp.async), got "
                             f"address {t.data_ptr()} and strides {t.stride()} of {size} bytes")
    return fill


_fn = None
_SMS: Dict[int, int] = {}


def _forward_fn():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        for name in ("da_tile", "da_stages", "da_threads"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], ctypes.c_int
        lib.da_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.da_smem_bytes.restype = ctypes.c_longlong
        have = (lib.da_tile(), lib.da_stages(), lib.da_threads(), lib.da_smem_bytes(1, 128, 4),
                lib.da_smem_bytes(0, 256, 16))
        want = (TILE, STAGES, THREADS, smem_bytes(torch.bfloat16, 128, 4), smem_bytes(torch.float32, 256, 16))
        if have != want:
            raise RuntimeError(f"decode_attention: the kernel's tile, stages, threads and shared memory "
                               f"are {have}; the plan's are {want}")
        fn = lib.da_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, L, Hkv, D)
    v: torch.Tensor,  # (B, L, Hkv, D)
    fill_len: int,
) -> torch.Tensor:
    """Decode attention on the card; see :func:`repro_torch.kernels.ref.decode_attention_ref`."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"decode_attention: {name} lies on {t.device}, not on a CUDA device")
    if not q.device == k.device == v.device:
        raise ValueError("decode_attention: inputs must lie on one device")
    p = plan(q, k, v, fill_len, _sms(q.device))
    B, _, Hkv, D = k.shape
    Hq = q.shape[2]
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    part = part_ml = None
    if p.splits > 1:
        part = torch.empty((B, Hq, p.splits, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, Hq, p.splits, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _forward_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None, part_ml.data_ptr() if part_ml is not None else None,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], B, Hkv, Hq // Hkv, D, int(fill_len),
            p.tiles_per_split, p.splits, q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with cudaError_t {err}")
    LAUNCHES += p.launches
    obs.record("rt.attention.decode", fill_len, p.splits)
    return out
