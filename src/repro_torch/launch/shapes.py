"""Assigned input shapes x applicability, and per-cell launch parameters.

LM transformer shapes (assignment brief):
  train_4k     seq 4,096   global_batch 256   (training)      -> train_step
  prefill_32k  seq 32,768  global_batch 32    (prefill)       -> prefill_step
  decode_32k   seq 32,768  global_batch 128   (decode)        -> serve_step
  long_500k    seq 524,288 global_batch 1     (long decode)   -> serve_step

``long_500k`` requires sub-quadratic attention — skipped for pure
full-attention archs (DESIGN.md §4), run for SSM / hybrid / SWA / 5:1-local
archs.  Gradient-accumulation steps are sized so the per-device microbatch
stays ~1 row on the data axis for the largest models (saved-residual memory
scales with the microbatch under layer-scan remat).

The port's own copy of ``repro.launch.shapes``, over the port's config
registry (:mod:`repro_torch.configs`).  It holds no hardware number.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.models.config import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "cell_applicable", "accum_steps_for", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs allowed to run long_500k (sub-quadratic decode; DESIGN.md §4)
LONG_CAPABLE = {
    "xlstm-350m",       # recurrent O(1) state
    "jamba-v0.1-52b",   # mamba-dominant hybrid
    "mixtral-8x7b",     # sliding-window attention (ring-buffer KV)
    "gemma3-12b",       # 5:1 local:global
    "gemma3-1b",        # 5:1 local:global
}

SKIP_REASONS = {
    ("nemotron-4-340b", "long_500k"): "pure full attention (quadratic prefill, O(seq) full-KV decode)",
    ("stablelm-3b", "long_500k"): "pure full attention",
    ("granite-moe-3b-a800m", "long_500k"): "pure full attention",
    ("phi-3-vision-4.2b", "long_500k"): "pure full attention (phi3-mini backbone)",
    ("whisper-base", "long_500k"): "enc-dec; decoder context is 448 tokens by construction",
}


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CAPABLE:
        return False, SKIP_REASONS.get((arch, shape), "full attention")
    return True, ""


def accum_steps_for(arch: str, shape: ShapeSpec, data_parallel: int) -> int:
    """Gradient-accumulation steps for train cells (memory-driven)."""
    if shape.kind != "train":
        return 1
    cfg = get_config(arch)
    # target microbatch rows per data shard: 1 for giant models, more for small
    if cfg.d_model >= 8_000:
        per_shard = 1
    elif cfg.d_model >= 2_500:
        per_shard = 2
    else:
        per_shard = 8
    micro_global = max(per_shard * data_parallel, 1)
    accum = max(shape.global_batch // micro_global, 1)
    while shape.global_batch % (accum) != 0 or (shape.global_batch // accum) % data_parallel != 0:
        accum -= 1
    return max(accum, 1)


def all_cells():
    from repro_torch.configs import ARCH_IDS, ALIASES

    inv = {v: k for k, v in ALIASES.items()}
    for arch_mod in ARCH_IDS:
        arch = inv[arch_mod]
        for shape in SHAPES.values():
            yield arch, shape
