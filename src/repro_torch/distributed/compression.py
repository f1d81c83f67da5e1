"""Gradient compression with error feedback (counterpart of ``repro.distributed.compression``).

Cross-pod bandwidth is the scarcest on the multi-pod mesh, and the cross-pod
traffic is one gradient all-reduce per step. An int8 block-quantised
all-reduce cuts those bytes 4x against fp32 (2x against bf16); the
quantisation error is carried in an error-feedback buffer so the
*accumulated* update stays unbiased (EF-SGD / 1-bit-Adam lineage).

``compressed_psum`` reduces over a ``torch.distributed`` process group (the
mesh dimension's: ``mesh.get_group("pod")``); the quantisation math is plain
torch and is tested on its own. The reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.tree import flatten_with_paths, unflatten

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "ef_compress",
    "compressed_psum",
]

_BLOCK = 2048  # quantization block (per-block scales bound the error)


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _BLOCK), pad


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) -> (int8 blocks, fp32 per-block scales, pad)."""
    blocks, pad = _pad_to_block(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    # a true division by the scales, as the reference's; round half to even as jnp.round
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, pad: int, shape: Tuple[int, ...]
) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def ef_compress(x: torch.Tensor, error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression: returns (decoded(x+error), new_error)."""
    target = x.to(torch.float32) + error
    q, s, pad = quantize_int8(target)
    decoded = dequantize_int8(q, s, pad, tuple(x.shape))
    return decoded, target - decoded


def compressed_psum(
    grads: Any, error: Any, group: Optional[dist.ProcessGroup] = None
) -> Tuple[Any, Any]:
    """Per-leaf int8 EF-quantised sum over ``group`` (the default group if None).

    Returns (reduced grads fp32, new error tree). int8 payloads are summed
    in int32 (no overflow for group sizes << 2^23) and rescaled by the mean of
    the members' scales — a standard compressed-allreduce approximation
    whose residual lands in the error buffer next step. The reference's order
    of operations: quantise, decode locally for the new error, sum the codes,
    average the scales, decode the sum.
    """
    n = dist.get_world_size(group)

    def one(g, e):
        target = g.to(torch.float32) + e
        q, s, pad = quantize_int8(target)
        decoded_local = dequantize_int8(q, s, pad, tuple(g.shape))
        new_e = target - decoded_local
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        scale = s.clone()
        dist.all_reduce(scale, op=dist.ReduceOp.SUM, group=group)  # gloo has no AVG
        scale = scale / n
        reduced = dequantize_int8(summed, scale, pad, tuple(g.shape))
        return reduced, new_e

    flat_g = [leaf for _, leaf in flatten_with_paths(grads)]
    flat_e = [leaf for _, leaf in flatten_with_paths(error)]
    if len(flat_g) != len(flat_e):
        raise ValueError("compressed_psum: grads and error differ in their leaves")
    out = [one(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])
