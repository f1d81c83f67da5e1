"""Roofline-term derivation from the dry-run records (counterpart of
``repro.analysis.roofline``).

Per (arch x shape x mesh) cell:

  compute term    = FLOPs      / (chips x CHIP_FLOPS_BF16)
  memory term     = bytes      / (chips x HBM_BW)
  collective term = coll_bytes / (chips x LINK_BW)

FLOPs and bytes come from the composite cost (:mod:`repro_torch.launch.dryrun`
traces 0- and 1-unit mini-models; ``total = mini0 + unit x repeats``) when the
record has one, else from the record itself. Collective bytes are per-device
sums multiplied by the device count (the machine's total).

MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for
inference shapes. The MODEL/counted ratio flags remat or redundant compute.
:func:`step_model_flops` adds the attention products that the mask keeps:
the numerator of a step's MFU, where the counted FLOPs of a trace at
``impl="ref"`` also hold the full S x S score products and the
rematerialised forward.

The constants are a parameter (anything with ``CHIP_FLOPS_BF16``, ``HBM_BW``
and ``LINK_BW``); the default is the H100's (:mod:`repro_torch.analysis.constants`).
Records are read from ``artifacts/dryrun_h100/``, never from the reference's
``artifacts/dryrun/``, which holds its TPU records.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from repro_torch.analysis import constants as h100
from repro_torch.configs import get_config
from repro_torch.launch.shapes import SHAPES
from repro_torch.models.config import ArchConfig, LayerKind
from repro_torch.models.transformer import _window

__all__ = ["roofline_terms", "model_flops", "attention_flops", "step_model_flops", "roofline_row",
           "load_record", "ART_DIR"]

ART_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_h100")
)


def load_record(arch: str, shape: str, multi_pod: bool = False,
                art_dir: Optional[str] = None) -> Optional[Dict]:
    key = f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}"
    path = os.path.join(art_dir or ART_DIR, key + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def model_flops(arch: str, shape: str) -> float:
    """Analytic useful FLOPs for the whole cell (6ND train / 2ND inference)."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    n_active = cfg.param_count(active_only=True)
    if sh.kind == "train":
        tokens = sh.global_batch * sh.seq_len
        return 6.0 * n_active * tokens
    if sh.kind == "prefill":
        tokens = sh.global_batch * sh.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * sh.global_batch  # decode: one token per request


def attention_flops(cfg: ArchConfig, kind: str, seq_len: int, batch: int) -> float:
    """The decoder's causal self-attention products over one step: QK^T and
    PV, a multiply-add each, 4 * n_heads * head_dim FLOPs a (query, key)
    pair a layer, over the pairs the mask keeps (``sum_i min(i + 1, w)``
    for a window w); x3 in training (the forward and the two products of
    the backward). An encoder's and cross-attention's are not counted."""
    per_pair = 4.0 * cfg.n_heads * cfg.resolved_head_dim
    total = 0.0
    for k in cfg.layer_kinds():
        if k not in (LayerKind.ATTN, LayerKind.LOCAL_ATTN):
            continue
        w = min(_window(cfg, k) or seq_len, seq_len)
        # the first w queries see 1..w keys, the other S - w see w each
        pairs = w * (w + 1) / 2 + (seq_len - w) * w
        total += per_pair * pairs * batch
    return total * (3.0 if kind == "train" else 1.0)


def step_model_flops(arch: str, kind: str, seq_len: int, batch: int) -> float:
    """A step's model FLOPs, the numerator of its MFU: 6 * N_active FLOPs a
    token in training, 2 * N_active in a prefill (:func:`model_flops`'s
    rule), plus :func:`attention_flops`."""
    cfg = get_config(arch)
    per_token = (6.0 if kind == "train" else 2.0) * cfg.param_count(active_only=True)
    return per_token * seq_len * batch + attention_flops(cfg, kind, seq_len, batch)


def roofline_terms(rec: Dict, constants: Any = None) -> Optional[Dict[str, Any]]:
    """Three terms in seconds + diagnostics, from one dry-run record."""
    c = constants or h100
    if not rec.get("ok") or rec.get("skipped"):
        return None
    chips = rec.get("devices", 256)
    comp = (rec.get("cost") or {}).get("composite")
    if comp is None:
        flops_total = (rec.get("flops") or 0.0) * chips
        bytes_total = (rec.get("bytes_accessed") or 0.0) * chips
        coll_total = sum((rec.get("collectives") or {}).values()) * chips
        scan_corrected = False
    else:
        flops_total = comp["flops"] * chips
        bytes_total = comp["bytes_accessed"] * chips
        coll_total = sum(comp["collectives"].values()) * chips
        scan_corrected = True
    t_compute = flops_total / (chips * c.CHIP_FLOPS_BF16)
    t_memory = bytes_total / (chips * c.HBM_BW)
    t_coll = coll_total / (chips * c.LINK_BW)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops_total": flops_total,
        "hlo_bytes_total": bytes_total,
        "collective_bytes_total": coll_total,
        "scan_corrected": scan_corrected,
        "chips": chips,
    }


def roofline_row(arch: str, shape: str, multi_pod: bool = False, constants: Any = None,
                 art_dir: Optional[str] = None) -> Optional[Dict]:
    c = constants or h100
    rec = load_record(arch, shape, multi_pod, art_dir)
    if rec is None:
        return None
    if rec.get("skipped"):
        return {"arch": arch, "shape": shape, "skipped": True, "reason": rec.get("reason", "")}
    terms = roofline_terms(rec, c)
    if terms is None:
        return {"arch": arch, "shape": shape, "failed": True, "error": rec.get("error")}
    mf = model_flops(arch, shape)
    t_bound = max(terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"])
    t_ideal = mf / (terms["chips"] * c.CHIP_FLOPS_BF16)
    row = {
        "arch": arch,
        "shape": shape,
        **terms,
        "model_flops": mf,
        "useful_ratio": mf / terms["hlo_flops_total"] if terms["hlo_flops_total"] else None,
        # roofline fraction: ideal compute time / achievable-bound time
        "roofline_fraction": t_ideal / t_bound if t_bound > 0 else None,
        "temp_bytes_per_device": rec.get("temp_size_in_bytes"),
        "argument_bytes_per_device": rec.get("argument_size_in_bytes"),
    }
    return row
