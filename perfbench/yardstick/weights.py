"""Seeded weights, made on the device in the tree the program describes.

The program's ``abstract_params(cfg)`` gives the keys, shapes and dtypes (meta
tensors, no values). The values are the benchmark's own: one flat buffer per
dtype, filled from one ``torch.Generator`` on the device in a few large
``normal_`` calls, then shaped per leaf by the leaf's name:

* a norm's ``scale`` and any other vector: 1 + 0.1 n;
* ``embed``, ``unembed``, and every matrix or stack of matrices: n / sqrt(fan-in),
  the fan-in being the second-to-last axis (``x @ w`` layout) and, for the
  embedding, the width d (the program multiplies the rows by sqrt(d), so the
  residual stream starts at unit scale);
* the mamba mixer's ``log_a``: log(1..N) on every channel (S4D-real), its
  ``d_skip``: ones, its ``dt_bias``: softplus^-1 of a step between 1e-3 and
  1e-1 (10^(-2 + n/2), n clipped to [-2, 2]), the range in which the
  published mamba initialises it.

The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

__all__ = ["make_weights", "leaf_paths", "layer_view"]

CHUNK = 1 << 30  # numbers drawn by one normal_ call
ALIGN = 128  # leaf offsets in elements (256 bytes in bf16): every leaf starts aligned


def leaf_paths(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in sorted key order."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from leaf_paths(node, (*prefix, key))
        else:
            yield (*prefix, key), node


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: torch.Tensor) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _shape_leaf(path: Tuple[str, ...], w: torch.Tensor, d: int) -> None:
    """Turn the standard normal draw ``w`` into the leaf's values, in place."""
    name = path[-1]
    if name == "log_a":  # (..., di, N)
        n = w.shape[-1]
        states = torch.arange(1, n + 1, dtype=torch.float32, device=w.device)
        w.copy_(torch.log(states).expand(w.shape))
    elif name == "d_skip":
        w.fill_(1.0)
    elif name == "dt_bias":
        step = torch.exp(w.float().clamp_(-2.0, 2.0) * (math.log(10.0) / 2) + math.log(1e-2))
        w.copy_(torch.log(torch.expm1(step)))
    elif name in ("embed", "unembed"):
        w.mul_(1.0 / math.sqrt(d))
    elif w.dim() >= 2 and name != "scale" and not (len(path) > 1 and path[-2].startswith("norm")):
        w.mul_(1.0 / math.sqrt(w.shape[-2]))
    else:
        w.mul_(0.1).add_(1.0)


def make_weights(abstract: Dict[str, Any], seed: int, device: torch.device,
                 d: int) -> Dict[str, Any]:
    """Real tensors on ``device`` with ``abstract``'s keys, shapes and dtypes."""
    leaves: List[Tuple[Tuple[str, ...], Any]] = list(leaf_paths(abstract))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    offsets: Dict[torch.dtype, int] = {}
    placed = []
    for path, meta in leaves:
        off = offsets.get(meta.dtype, 0)
        placed.append((path, meta, off))
        offsets[meta.dtype] = off + -(-meta.numel() // ALIGN) * ALIGN
    buffers = {}
    for dtype in sorted(offsets, key=str):
        flat = torch.empty(offsets[dtype], dtype=dtype, device=device)
        for i in range(0, flat.numel(), CHUNK):
            flat[i : i + CHUNK].normal_(generator=gen)
        buffers[dtype] = flat
    tree: Dict[str, Any] = {}
    for path, meta, off in placed:
        w = buffers[meta.dtype][off : off + meta.numel()].view(meta.shape)
        _shape_leaf(path, w, d)
        _set(tree, path, w)
    return tree


def layer_view(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights (views): the program stacks unit position ``u``
    of every repeat ``r`` under ``blocks/u{u}``, layer i = r * units + u."""
    units = len(tree["blocks"])
    block = tree["blocks"][f"u{i % units}"]
    r = i // units

    def pick(node):
        return {k: pick(v) for k, v in node.items()} if isinstance(node, dict) else node[r]

    return pick(block)
