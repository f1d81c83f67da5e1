"""Shares of a peak that the per-layer readers under ``perfbench/metrics`` take
from a traced slice.

A kernel's roofline share: the least time the slice's work for that kernel
needs (:mod:`yardstick.work`, from the shapes the traffic gave and the
configuration's file) over the device time of the kernels of that name in the
trace; None where the trace holds none of them. A step's MFU: the window's
model FLOPs at the bf16 peak over the window's time. Each share is in %.
Each reader's bound, with the side that sets it, goes into ``ctx.notes``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

from yardstick import work

__all__ = ["roofline", "mfu", "gmm_work", "attention_work", "scan_work"]


def roofline(ctx, name: str, kernels: Sequence[str],
             pieces: Callable[[object], Iterable[Tuple[float, float, float]]]) -> Optional[float]:
    """``pieces(ctx)`` yields (flops, bytes, peak) for each piece of work in
    the traced slice; each piece is bounded alone and the bounds summed."""
    device_s = ctx.trace.device_seconds(kernels)
    if device_s <= 0 or not ctx.traced:
        return None
    ops_s = bytes_s = bound = 0.0
    for flops, nbytes, peak in pieces(ctx):
        bound += work.least_seconds(flops, nbytes, peak)[0]
        ops_s += flops / peak
        bytes_s += nbytes / work.HBM_BW
    side = "operations" if ops_s >= bytes_s else "bytes"
    ctx.notes.append(f"{name}: bound {bound * 1e3!r} ms (operations {ops_s * 1e3!r} ms, bytes "
                     f"{bytes_s * 1e3!r} ms, set by {side}) over {device_s * 1e3!r} ms of "
                     f"{'/'.join(kernels)} in {ctx.trace.count(kernels)} launches")
    return 100.0 * bound / device_s


def gmm_work(ctx):
    """K4: the three expert products of every MoE layer of every traced
    prompt or step, over the rows the capacity keeps (``ctx.routed``: per
    prompt or step, per MoE layer, the kept copies and the experts that got
    any, as the reference routed the same tokens)."""
    for layers in ctx.routed:
        for rows, experts in layers:
            for flops, nbytes in work.moe_products(ctx.shape, rows, experts):
                yield flops, nbytes, work.PEAK_BF16


def attention_work(ctx):
    """K1: every attention layer of every traced prompt."""
    s = ctx.shape
    for n in ctx.traced:
        for _ in range(s.attention_layers):
            flops, nbytes = work.attention_work(ctx.batch, n, n, s.heads, s.kv_heads, s.head_dim,
                                                True, s.window)
            yield flops, nbytes, work.PEAK_BF16


def scan_work(ctx):
    """K2: every mamba layer's scan of every traced prompt, at the fp32 CUDA-core rate."""
    s = ctx.shape
    for n in ctx.traced:
        for _ in range(s.mamba_layers):
            flops, nbytes = work.scan_work(ctx.batch, n, s.mamba_inner, s.mamba_state)
            yield flops, nbytes, work.PEAK_FP32


def mfu(ctx) -> float:
    """The window's model FLOPs at the bf16 peak over the window's time, in %."""
    if ctx.kind == "prefill":
        flops = sum(work.step_model_flops(ctx.shape, n, ctx.batch) for n in ctx.work)
    else:
        flops = sum(work.decode_model_flops(ctx.shape, ctx.batch, k) for k in ctx.work)
    return 100.0 * flops / (work.PEAK_BF16 * ctx.window_s)
