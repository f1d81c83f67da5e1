"""Wrapper of the hand-written Hopper selective-scan kernel ``csrc/mamba_scan.cu``.

Counterpart of ``repro.kernels.mamba_scan.mamba_scan`` (the Pallas TPU
kernel); same arguments and semantics as
:func:`repro_torch.kernels.ref.mamba_scan_ref`. x, dt and the output share one
type (float32 or bfloat16), B and C one type of their own, A and D are
float32. Rows of every input may be strided (B and C are slices of one
projection in the mamba mixer); ragged T and Di are masked in the kernel.

The kernel scans all of T in one pass a block, one block per (64-channel
tile, batch row); :func:`plan` gives its grid and shared memory by shape.

This wrapper only launches: a tensor that is not on a card, or anything else
the kernel does not take, raises. The CPU path is ``ops.mamba_scan``'s choice
of the plain version, never a fallback here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["mamba_scan", "plan", "Plan", "LAUNCHES", "MAX_STATES", "STAGE"]

#: launches of the kernel in this process (incremented once per launch)
LAUNCHES = 0

#: the most states N a channel may have: 16 lanes of a warp hold 4 each
MAX_STATES = 64
#: steps of a stage (``ms_stage()`` of ``csrc/mamba_scan.cu``)
STAGE = 16
_THREADS = 128
_CHANNELS_PER_THREAD = 2
_STATES_PER_LANE = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = 2**31 - 1  # grid.x limit


@dataclasses.dataclass(frozen=True)
class Plan:
    """What a call launches: ``lanes`` lanes of a warp share a channel's
    states (4 each), ``channels`` channels make a block's tile; ``blocks`` is
    the launch's grid (tiles x batch rows), each block scanning all of T, and
    ``smem_bytes`` its static shared memory a block."""

    lanes: int
    channels: int
    tiles: int
    blocks: int
    smem_bytes: int


def plan(x, dt, A, B, C, D) -> Plan:
    """The call's grid and shared memory for these inputs (no card needed);
    raises on what the kernel does not take."""
    _check_layout(x, dt, A, B, C, D)
    Bsz, T, Di = x.shape
    return _plan(Bsz, Di, A.shape[-1])


@functools.lru_cache(maxsize=256)
def _plan(Bsz: int, Di: int, N: int) -> Plan:
    lanes = 4 if N <= 16 else 8 if N <= 32 else 16
    channels = _THREADS // lanes * _CHANNELS_PER_THREAD
    tiles = -(-Di // channels)
    blocks = tiles * Bsz
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"mamba_scan: {blocks} blocks exceed the grid's {_MAX_BLOCKS}")
    # two buffers of dt and x (transposed, rows of STAGE + 4) and of B and C,
    # and each thread's row of partial y sums (both channels)
    smem = 4 * (2 * 2 * channels * (STAGE + 4) + 2 * 2 * STAGE * lanes * _STATES_PER_LANE
                + _THREADS * (_CHANNELS_PER_THREAD * STAGE + 4))
    return Plan(lanes, channels, tiles, blocks, smem)


def _check_layout(x, dt, A, B, C, D) -> None:
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


def _check_devices(named) -> None:
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"mamba_scan: {name} lies on {t.device}, not on a CUDA device")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("mamba_scan: inputs must lie on one device")


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("mamba_scan")
        lib.ms_stage.argtypes, lib.ms_stage.restype = [], ctypes.c_int
        lib.ms_lanes.argtypes, lib.ms_lanes.restype = [ctypes.c_int], ctypes.c_int
        if lib.ms_stage() != STAGE or lib.ms_lanes(16) != _plan(1, 1, 16).lanes:
            raise RuntimeError(f"mamba_scan: the kernel's stage is {lib.ms_stage()} steps and N 16 takes "
                               f"{lib.ms_lanes(16)} lanes; the plan's are {STAGE}, {_plan(1, 1, 16).lanes}")
        lib.ms_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
                                   + [ctypes.c_void_p])
        lib.ms_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    _check_devices((("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)))
    plan(x, dt, A, B, C, D)
    Bsz, T, Di = x.shape
    N = A.shape[-1]
    y = torch.empty((Bsz, T, Di), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _library().ms_forward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[B.dtype], Bsz, T, Di, N,
            *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2], *C.stride()[:2],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan: kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return y
