"""Roofline-derived job elasticity (the paper's Fig. 2 from first principles).

For a job running on a sub-mesh of ``k``/7 of the pod:

* compute and HBM terms scale ~1/k (more chips, same work),
* the collective term *degrades* slowly with k (bigger rings, longer paths):
  modelled as ``Tcoll * (1 + alpha*log2(k))``,
* shardability caps k: a decode batch of 1 row or 4 attention heads cannot
  use 7 slots productively (cap -> the paper's "capped" class).

``arch_elasticity`` loads per-(arch x shape) roofline terms from the dry-run
artifacts when available and falls back to the analytic FLOPs model, then
returns a normalized throughput curve tp(k) with tp(1)=1 — exactly the
object the paper draws synthetically (§V-A).

The port's own copy of ``repro.cluster.elasticity``.  The per-chip rates are
the simulated pod's modelled inputs (:mod:`repro_torch.cluster.pod`), and
``get_config`` / ``param_count`` are the port's registry's; the float
operations are the reference's, so both packages give the same curves.
"""

from __future__ import annotations

import glob
import json
import math
import os
from functools import lru_cache
from typing import Dict, Optional, Tuple

from repro_torch.cluster.pod import CHIP_FLOPS_BF16, HBM_BW, LINK_BW
from repro_torch.configs import get_config
from repro_torch.core.jobs import Elasticity, ElasticityClass
from repro_torch.launch.shapes import SHAPES

__all__ = ["service_minutes", "arch_elasticity", "classify_elasticity"]

CHIPS_PER_SLOT = 256 // 7  # ~36 chips per "slot"
COLL_ALPHA = 0.35  # collective degradation per log2(slots)


def _dryrun_record(arch: str, shape: str) -> Optional[Dict]:
    base = os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun"
    )
    path = os.path.abspath(os.path.join(base, f"{arch}__{shape}__pod.json"))
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("ok") and rec.get("cost"):
            return rec
    return None


def _analytic_terms(arch: str, shape: str) -> Tuple[float, float, float]:
    """(compute_s, memory_s, collective_s) on the FULL pod, analytic fallback."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    n_params = cfg.param_count(active_only=True)
    chips = 256
    if sh.kind == "train":
        flops = 6.0 * n_params * sh.global_batch * sh.seq_len
        bytes_ = 3 * 2.0 * cfg.param_count() + sh.global_batch * sh.seq_len * cfg.d_model * 2 * cfg.n_layers
        coll = 2.0 * 2 * cfg.param_count()  # grad all-reduce, bf16 ring
    elif sh.kind == "prefill":
        flops = 2.0 * n_params * sh.global_batch * sh.seq_len
        bytes_ = 2.0 * cfg.param_count() + sh.global_batch * sh.seq_len * cfg.d_model * 2 * cfg.n_layers
        coll = 0.3 * 2 * cfg.param_count()
    else:  # decode: one token per request
        flops = 2.0 * n_params * sh.global_batch
        kv = (
            cfg.n_layers * sh.global_batch * min(sh.seq_len, cfg.sliding_window or sh.seq_len)
            * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * 2
        )
        bytes_ = 2.0 * cfg.param_count() + kv
        coll = 0.1 * 2 * cfg.param_count()
    return (
        flops / (chips * CHIP_FLOPS_BF16),
        bytes_ / (chips * HBM_BW),
        coll / (chips * LINK_BW),
    )


@lru_cache(maxsize=None)
def _terms(arch: str, shape: str) -> Tuple[float, float, float]:
    rec = _dryrun_record(arch, shape)
    if rec is not None:
        comp = rec["cost"]["composite"]
        chips = rec.get("devices", 256)
        flops = comp["flops"] * chips  # per-device -> total
        bytes_ = comp["bytes_accessed"] * chips
        coll = sum(comp["collectives"].values()) * chips
        return (
            flops / (chips * CHIP_FLOPS_BF16),
            bytes_ / (chips * HBM_BW),
            coll / (chips * LINK_BW),
        )
    return _analytic_terms(arch, shape)


def _max_parallel_slots(arch: str, shape: str) -> int:
    """Shardability cap in slots (1..7)."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if sh.kind == "decode":
        # parallelism: batch rows x kv-groups x (seq for attention caches)
        par = sh.global_batch * max(cfg.n_kv_heads, 1)
        if cfg.block_pattern in ("xlstm",):
            par = sh.global_batch * max(cfg.d_model // 128, 1)
        chips = min(par, 256)
    elif sh.kind == "prefill":
        chips = min(sh.global_batch * sh.seq_len // 2048, 256)
    else:
        chips = 256
    # small models also cap on useful TP width
    tp_cap = max(cfg.d_model // 256, 1) * max(cfg.n_heads, 1)
    chips = min(chips, tp_cap * 8)
    return max(1, min(7, round(chips / CHIPS_PER_SLOT) or 1))


def service_minutes(arch: str, shape: str, slots: float) -> float:
    """Wall-clock minutes for one job quantum on ``slots``/7 of the pod."""
    tc, tm, tcoll = _terms(arch, shape)
    k = max(min(slots, 7.0), 1e-6)
    kcap = float(_max_parallel_slots(arch, shape))
    ke = min(k, kcap)  # beyond the cap, extra slots do nothing
    t = max(
        tc * 7.0 / ke,
        tm * 7.0 / ke,
        tcoll * (1.0 + COLL_ALPHA * math.log2(max(ke, 1.0))) * 7.0 / ke if tcoll else 0.0,
    )
    quanta = _JOB_QUANTA.get(shape, 1.0)
    return max(t, 1e-9) * quanta / 60.0


# one "job" = this many step/request quanta (sized so jobs land in the
# paper's §V-A duration regime: inference ~minutes, training ~tens of min)
_JOB_QUANTA = {
    "train_4k": 200.0,  # 200 training steps (fine-tuning burst)
    "prefill_32k": 2_000.0,  # batched prefill session
    "decode_32k": 200_000.0,  # serving session: 200k decode steps
    "long_500k": 100_000.0,
}


def arch_elasticity(arch: str, shape: str) -> Elasticity:
    """Normalized throughput curve tp(k), tp(1)=1, from the roofline model."""
    t1 = service_minutes(arch, shape, 1)

    def tp(k: float) -> float:
        return t1 / service_minutes(arch, shape, k)

    label = f"{arch}:{shape}"
    return Elasticity(classify_elasticity(tp), label, tp)


def classify_elasticity(tp) -> ElasticityClass:
    """Map a tp curve onto the paper's three classes (Fig. 2)."""
    t7 = tp(7.0)
    t4 = tp(4.0)
    if t7 >= 6.0:
        return ElasticityClass.LINEAR
    if t7 - t4 < 0.25:  # flat after mid-size: capped
        return ElasticityClass.CAPPED
    return ElasticityClass.SUBLINEAR
