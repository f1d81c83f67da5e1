"""The yardstick's arithmetic: the H100's peaks, each kernel's least time, a
step's model FLOPs.

Frozen copies, so that a change to the program cannot move the yardstick:

* the peaks: ``src/repro_torch/analysis/constants.py`` (NVIDIA H100 Tensor
  Core GPU datasheet, SXM5 column: 989 TFLOP/s dense bf16, 67 TFLOP/s fp32 on
  the CUDA cores, 3.35 TB/s of HBM3);
* :func:`attended_pairs`, :func:`attention_work`, :func:`scan_work`,
  :func:`gmm_work`: ``chip_smoke.py``'s ``_attended_pairs``, ``_bound_ms``,
  ``_scan_bound`` and ``_gmm_bound``. ``gmm_work`` is handed the routed rows
  that the capacity keeps, never the capacity-padded buffer nor the copies
  it drops: a grouped product is charged only for the rows it must compute;
* :func:`step_model_flops`: ``src/repro_torch/analysis/roofline.py``'s
  ``step_model_flops`` and ``attention_flops``, with the parameter count of
  ``ArchConfig.param_count(active_only=True)``, counted from the
  configuration's file (:class:`yardstick.model.Shape`). One departure: the
  input embedding is a row gather, not a product, and is not counted.

Operations and bytes are counted from the shapes the traffic gives; each
input byte read once, each output byte written once.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from yardstick.model import Shape

__all__ = ["PEAK_BF16", "PEAK_FP32", "HBM_BW", "least_seconds", "attended_pairs",
           "attention_work", "scan_work", "gmm_work", "moe_products", "active_params",
           "token_flops", "step_model_flops", "decode_model_flops"]

PEAK_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_FP32 = 67e12  # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s


def least_seconds(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    """The least time of some work, and which side bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


@functools.lru_cache(maxsize=64)
def attended_pairs(sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int = 0) -> int:
    """(query, key) pairs that the causal mask and the window keep."""
    q = np.arange(sq)[:, None] + q_offset
    k = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    return int(ok.sum())


def attention_work(b: int, sq: int, sk: int, hq: int, hkv: int, dh: int, causal: bool,
                   window: Optional[int]) -> Tuple[float, float]:
    """One attention call: 4*D FLOP per attended pair and head; q, k, v read
    once and the output written once, in bf16."""
    nbytes = 2 * dh * (2 * b * sq * hq + 2 * b * sk * hkv)
    flops = 4 * dh * b * hq * attended_pairs(sq, sk, causal, window)
    return float(flops), float(nbytes)


def scan_work(b: int, t: int, di: int, n: int) -> Tuple[float, float]:
    """One selective scan: x, dt, y (b, t, di) and B, C (b, t, n) in bf16, A
    and D in fp32, moved once; 7 fp32 operations per (b, t, d, n) and 3 per
    (b, t, d), at the fp32 CUDA-core rate."""
    nbytes = 3 * b * t * di * 2 + 2 * b * t * n * 2 + 4 * (di * n + di)
    ops = 7 * b * t * di * n + 3 * b * t * di
    return float(ops), float(nbytes)


def gmm_work(rows: int, k: int, n: int, groups: int, in_bytes: int,
             out_bytes: int) -> Tuple[float, float]:
    """One grouped product over ``rows`` routed rows: lhs, the weight matrix of
    every group that gets rows, and the output moved once; 2*rows*k*n FLOP."""
    nbytes = in_bytes * (rows * k + groups * k * n) + out_bytes * rows * n
    return float(2 * rows * k * n), float(nbytes)


def moe_products(shape: Shape, rows: int, experts: int):
    """The three expert products of one MoE layer over ``rows`` kept (token,
    expert) rows that reach ``experts`` experts: (flops, bytes) each. Up and
    gate return fp32, down the activations' bf16."""
    up = gmm_work(rows, shape.d, shape.expert_ff, experts, 2, 4)
    down = gmm_work(rows, shape.expert_ff, shape.d, experts, 2, 2)
    return (up, up, down)


def active_params(shape: Shape) -> int:
    """The parameters a token multiplies, as ``ArchConfig.param_count(
    active_only=True)`` counts them, less the input embedding."""
    d, hd = shape.d, shape.head_dim
    total = shape.vocab * d  # the output head
    for kind, moe in shape.layers:
        if kind == "attention":
            total += d * shape.heads * hd + 2 * d * shape.kv_heads * hd + shape.heads * hd * d
        else:
            di, n, r = shape.mamba_inner, shape.mamba_state, shape.mamba_dt_rank
            total += d * 2 * di + di * shape.mamba_conv + di * (r + 2 * n) + r * di + di * n
            total += di * d
        if moe:
            total += shape.top_k * 3 * d * shape.expert_ff + d * shape.experts
        elif shape.dense_ff:
            total += 3 * d * shape.dense_ff
        total += 2 * d  # norms
    return total


def token_flops(shape: Shape) -> float:
    """2 FLOP per active parameter."""
    return 2.0 * active_params(shape)


def step_model_flops(shape: Shape, seq_len: int, batch: int = 1) -> float:
    """A prefill of ``batch`` sequences of ``seq_len`` tokens: 2 N_active FLOP a
    token plus 4 * heads * head_dim a layer for each pair the mask keeps."""
    per_pair = 4.0 * shape.heads * shape.head_dim
    pairs = attended_pairs(seq_len, seq_len, True, shape.window)
    return token_flops(shape) * seq_len * batch + per_pair * pairs * batch * shape.attention_layers


def decode_model_flops(shape: Shape, batch: int, keys: int) -> float:
    """One decode step of ``batch`` tokens, each attending ``keys`` cached
    positions (the window's share of them)."""
    kept = keys if shape.window is None else min(keys, shape.window)
    per_pair = 4.0 * shape.heads * shape.head_dim
    return batch * (token_flops(shape) + per_pair * kept * shape.attention_layers)
