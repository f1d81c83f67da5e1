"""Multi-card dry-run: prove every (arch x shape x mesh) cell places, shards
and runs one step on the production mesh of H100s — and extract its roofline
terms (counterpart of ``repro.launch.dryrun``).

``python -m repro_torch.launch.dryrun --arch A --shape S [--multi-pod]
[--no-cost] [--out DIR] [--device cpu]``

The torch analogue of lowering a cell on 256 placeholder devices (the method
of torchtitan's estimation script): a ``fake`` process group of 256 (or 512)
ranks, a :class:`DeviceMesh` over it, and ``FakeTensorMode``, so no tensor
holds memory and no collective moves data. This process plays rank 0: every
input is a DTensor whose local shard has rank 0's shape (the rules of
:mod:`repro_torch.distributed.sharding`), and one step runs at ``impl="ref"``
(a train step with :func:`accum_steps_for`'s microbatches, a prefill or a
serve step) under a dispatch mode that sees each local aten op the DTensor
layer issues. Per cell (written under ``artifacts/dryrun_h100/``):

* ``argument_size_in_bytes`` — the local shard bytes of the step's inputs;
* ``output_size_in_bytes``   — the local bytes of its outputs;
* ``temp_size_in_bytes``     — the peak of live local bytes made by the step
  (above the arguments; its outputs included);
* ``flops``                  — per device, the local ops' FLOPs by
  ``torch.utils.flop_counter``'s formulas (matmuls; elementwise ops count 0);
* ``bytes_accessed``         — the inputs plus outputs of each local aten op
  (views excluded). Unfused: an upper bound on what a fused step moves;
* ``collectives``            — result bytes of each ``c10d_functional`` op,
  by the reference's names (``all-gather``, ``all-reduce``, ...);
* ``fits``                   — arguments plus temporaries within 80 GB.

The sizes are modelled for 256 H100s: nothing ran on a card.

The port has no scan, so a trace walks every layer and microbatch. Two
compositions keep a trace short, as the reference's keeps its compile short:
a main record whose step would run more than ``MAX_LAYER_PASSES`` layer
passes is extrapolated from traces at 1 and 2 pattern repeats
(``total = r1 + (r2 - r1) x (repeats - 1)``, recorded under
``depth_extrapolated``); and :func:`composite_cost` traces 0- and 1-unit
mini-models without remat or accumulation (``total = mini0 + unit x
repeats``), so nemotron's 96 layers are never traced whole.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.analysis.constants import HBM_BYTES
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    local_shape_offset,
    param_shardings,
    placements,
    spec_leaves,
)
from repro_torch.distributed.step import make_prefill_step, make_serve_step, make_train_step
from repro_torch.launch.mesh import make_production_mesh, set_ambient_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, accum_steps_for, cell_applicable
from repro_torch.models import abstract_params, init_cache
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.tree import flatten_with_paths, leaves, unflatten

__all__ = ["runtime_config", "make_optimizer", "input_specs", "lower_cell", "composite_cost",
           "run_cell", "fake_world", "CostMode", "ARTIFACTS"]

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_h100")

# a main record whose step runs more layer passes than this (layers x
# microbatches x 3 for a remat train step) is extrapolated in depth
MAX_LAYER_PASSES = 400

NOTES = ("per device, modelled for H100s on a fake process group under FakeTensorMode; "
         "bytes_accessed sums each local aten op's inputs and outputs unfused (an upper bound "
         "on a fused step's traffic); flops count matmuls only")

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


# ------------------------------ fake world ----------------------------------


def fake_world(world_size: int) -> None:
    """A single-process ``fake`` process group of ``world_size`` ranks (this
    process is rank 0). Process-wide: an existing default group of another
    size is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


# ------------------------------ cost mode -----------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    return [t for t in leaves(x) if isinstance(t, torch.Tensor)] if isinstance(
        x, (list, tuple, dict)) else ([x] if isinstance(x, torch.Tensor) else [])


class CostMode:
    """A dispatch mode over the local aten ops of a step: FLOPs (the formulas
    of ``torch.utils.flop_counter``), bytes in and out of each op, collective
    result bytes by kind, and the peak of the live bytes of the storages the
    step makes. A call on DTensors is left to the DTensor layer
    (``NotImplemented``), which issues the local ops this mode then sees.
    The DTensor layer also infers output shapes by running ops on fake
    tensors of the global shapes (``ShardingPropagator``'s tensor-meta
    pass): those calls are not the step's work and are not counted."""

    def __init__(self) -> None:
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        outer = self
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

        def count(func, args, kwargs, out):
            packet = func._overloadpacket
            name = packet.__name__
            if "c10d_functional" in func.namespace:
                kind = _COLLECTIVES.get(name)
                if kind is not None:
                    nb = sum(_nbytes(t) for t in _tensors(out))
                    outer.collectives[kind] = outer.collectives.get(kind, 0.0) + nb
                return
            rets = func._schema.returns
            if rets and rets[0].alias_info is not None and not rets[0].alias_info.is_write:
                return  # a view: no bytes move
            flop = flop_registry.get(packet)
            if flop is not None:
                outer.flops += int(flop(*args, **kwargs, out_val=out))
            outer.bytes += sum(_nbytes(t) for t in _tensors(list(args) + list(kwargs.values())))
            outer.bytes += sum(_nbytes(t) for t in _tensors(out))

        def track(out):
            for t in _tensors(out):
                st = t.untyped_storage()
                key = st._cdata
                if key in outer._storages:
                    continue
                nb = st.nbytes()
                outer._storages[key] = nb
                outer.live += nb
                weakref.finalize(st, outer._free, key)
                if outer.live > outer.peak * 1.02 + (64 << 20):
                    # a new peak: first free what only reference cycles hold
                    # (autograd graphs of finished regions), which the cyclic
                    # collector would otherwise free at a time of its choosing
                    gc.collect()
                outer.peak = max(outer.peak, outer.live)

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not outer._inferring:
                    count(func, args, kwargs, out)
                    track(out)
                return out

        self._mode = _Mode()
        self._inferring = 0
        self._patched = None

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def known(self, tree) -> None:
        """Storages that exist before the step (its arguments): not counted as made."""
        for t in _tensors(tree):
            local = t.to_local() if hasattr(t, "to_local") else t
            self._storages.setdefault(local.untyped_storage()._cdata, 0)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator.__dict__.get("_propagate_tensor_meta_non_cached")
        if orig is not None:
            outer = self

            def inferring(prop, *a, **k):
                outer._inferring += 1
                try:
                    return orig(prop, *a, **k)
                finally:
                    outer._inferring -= 1

            ShardingPropagator._propagate_tensor_meta_non_cached = inferring
            self._patched = (ShardingPropagator, orig)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._mode.__exit__(*exc)
        finally:
            if self._patched is not None:
                cls, orig = self._patched
                cls._propagate_tensor_meta_non_cached = orig
                self._patched = None


# ----------------------------- abstract inputs ------------------------------


def runtime_config(arch: str, for_cost: bool = False, repeats: Optional[int] = None,
                   base: Optional[ArchConfig] = None) -> ArchConfig:
    """The cell's config (``base``, default the full one): scanned with remat,
    or for cost an unscanned, remat-free stack of ``repeats`` pattern units."""
    cfg = base or get_config(arch)
    if not for_cost:
        return dataclasses.replace(cfg, scan_layers=True, remat="block")
    unit_len = len(cfg.pattern_unit())
    assert repeats is not None
    changes: Dict[str, Any] = dict(n_layers=unit_len * repeats, scan_layers=False, remat="none")
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=repeats)
    return dataclasses.replace(cfg, **changes)


def make_optimizer(cfg: ArchConfig) -> AdamW:
    # bf16 optimizer states for the giant models
    state_dtype = "bfloat16" if cfg.d_model >= 8_000 else None
    return AdamW(AdamWConfig(lr=3e-4, state_dtype=state_dtype))


def _placed(t: torch.Tensor, spec, mesh, device) -> torch.Tensor:
    """A DTensor of ``t``'s global shape and dtype, placed by ``spec``, whose
    local shard is rank 0's (a fake tensor under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    shape, _ = local_shape_offset(tuple(t.shape), mesh, pl)
    local = torch.empty(shape, dtype=t.dtype, device=device)
    stride = []
    acc = 1
    for n in reversed(t.shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=tuple(t.shape),
                              stride=tuple(stride))


def _place_tree(tree, specs, mesh, device):
    flat = flatten_with_paths(tree)
    return unflatten(tree, [_placed(t, s, mesh, device)
                            for (_, t), s in zip(flat, spec_leaves(specs), strict=True)])


def input_specs(arch: str, shape: ShapeSpec, mesh, cfg: Optional[ArchConfig] = None,
                device: str = "cpu"):
    """The step's inputs as placed fake DTensors (call under FakeTensorMode),
    with their spec trees and the optimizer (train) or None."""
    cfg = cfg or runtime_config(arch)
    params_abs = abstract_params(cfg)
    # resident-weight (serve) sharding only pays when the batch amortises the
    # per-device weight reads; at batch 1 (long_500k) 2-D sharding reads 16x
    # less weight per device and the activation psums are tiny
    serve_mode = shape.kind != "train" and shape.global_batch >= 32
    p_spec = param_shardings(params_abs, mesh, mode="serve" if serve_mode else "train")
    params = _place_tree(params_abs, p_spec, mesh, device)

    if shape.kind == "train":
        opt = make_optimizer(cfg)
        opt_state = opt.init(leaves(params))  # zeros_like: m and v mirror the params
        batch = make_batch_specs(cfg, shape.global_batch, shape.seq_len, True)
        b_spec = batch_shardings(batch, mesh)
        return (params, opt_state, _place_tree(batch, b_spec, mesh, device)), \
            (p_spec, None, b_spec), opt
    if shape.kind == "prefill":
        batch = make_batch_specs(cfg, shape.global_batch, shape.seq_len, False)
        b_spec = batch_shardings(batch, mesh)
        return (params, _place_tree(batch, b_spec, mesh, device)), (p_spec, b_spec), None
    # decode
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
    c_spec = cache_shardings(cache, mesh, shape.global_batch)
    token = torch.empty((shape.global_batch, 1), dtype=torch.int32)
    args = [params, _place_tree(cache, c_spec, mesh, device), _placed(token, (), mesh, device)]
    specs = [p_spec, c_spec, ()]
    if cfg.encoder is not None:
        enc = torch.empty((shape.global_batch, cfg.encoder.n_frames, cfg.d_model),
                          dtype=torch.bfloat16)
        args.append(_placed(enc, (), mesh, device))
        specs.append(())
    return tuple(args), tuple(specs), None


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t) for t in _tensors(tree))


# ------------------------------ lowering ------------------------------------


def _data_parallel(mesh) -> int:
    return math.prod(n for a, n in zip(mesh.mesh_dim_names, mesh.shape, strict=True)
                     if a != "model")


def lower_cell(arch: str, shape: ShapeSpec, mesh, cfg: Optional[ArchConfig] = None,
               device: str = "cpu") -> Dict[str, Any]:
    """One step of the cell at ``cfg`` (default: the full runtime config),
    traced on fake tensors; its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or runtime_config(arch)
    t0 = time.time()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        set_ambient_mesh(mesh)
        with fake:
            args, _, opt = input_specs(arch, shape, mesh, cfg, device)
            if shape.kind == "train":
                accum = accum_steps_for(arch, shape, _data_parallel(mesh))
                if os.environ.get("REPRO_ACCUM_OVERRIDE"):
                    accum = int(os.environ["REPRO_ACCUM_OVERRIDE"])
                if not cfg.scan_layers:  # cost mode: no accumulation
                    accum = 1
                g_dt = "bfloat16" if cfg.d_model >= 8_000 else "float32"
                step = make_train_step(cfg, opt, accum_steps=accum, impl="ref",
                                       grad_accum_dtype=g_dt)
                call = lambda: step(*args)  # noqa: E731
            elif shape.kind == "prefill":
                step = make_prefill_step(cfg, impl="ref")
                call = lambda: step(*args)  # noqa: E731
            else:
                step = make_serve_step(cfg, impl="ref")
                enc = args[3] if len(args) > 3 else None
                call = lambda: step(args[0], args[1], args[2], shape.seq_len - 1,  # noqa: E731
                                    enc_out=enc)
            cost = CostMode()
            cost.known(args)
            with cost:
                out = call()
            rec: Dict[str, Any] = {
                "lower_seconds": time.time() - t0,
                "argument_size_in_bytes": _local_bytes(args),
                "output_size_in_bytes": _local_bytes(out),
                "temp_size_in_bytes": cost.peak,
                "flops": float(cost.flops),
                "bytes_accessed": float(cost.bytes),
                "collectives": dict(cost.collectives),
                "notes": NOTES,
            }
            if shape.kind == "train":
                rec["accum_steps"] = accum
            del out, args
    finally:
        set_ambient_mesh(None)
    return rec


_ADDITIVE = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "flops",
             "bytes_accessed")


def _layer_passes(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    if shape.kind != "train":
        return cfg.n_layers
    return cfg.n_layers * 3 * accum_steps_for(cfg.name, shape, _data_parallel(mesh))


def _extrapolated(r1: Dict, r2: Dict, repeats: int) -> Dict[str, Any]:
    """``r1 + (r2 - r1) x (repeats - 1)`` for the additive keys and each kind of collective."""
    out = dict(r2)
    for k in _ADDITIVE:
        out[k] = r1[k] + (r2[k] - r1[k]) * (repeats - 1)
    kinds = set(r1["collectives"]) | set(r2["collectives"])
    out["collectives"] = {k: r1["collectives"].get(k, 0.0) + (
        r2["collectives"].get(k, 0.0) - r1["collectives"].get(k, 0.0)) * (repeats - 1)
        for k in kinds}
    out["lower_seconds"] = r1["lower_seconds"] + r2["lower_seconds"]
    out["depth_extrapolated"] = {"from_repeats": [1, 2], "to_repeats": repeats}
    return out


def main_record(arch: str, shape: ShapeSpec, mesh, device: str = "cpu") -> Dict[str, Any]:
    """The cell's record at its full runtime config: traced whole, or
    extrapolated in depth when that trace is longer than ``MAX_LAYER_PASSES``."""
    cfg = runtime_config(arch)
    repeats = cfg.num_pattern_repeats
    if _layer_passes(cfg, shape, mesh) <= MAX_LAYER_PASSES or repeats < 3:
        return lower_cell(arch, shape, mesh, cfg, device)
    unit = len(cfg.pattern_unit())
    r1, r2 = (lower_cell(arch, shape, mesh, dataclasses.replace(cfg, n_layers=unit * n), device)
              for n in (1, 2))
    return _extrapolated(r1, r2, repeats)


def composite_cost(arch: str, shape: ShapeSpec, mesh, device: str = "cpu",
                   base: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Depth-free cost: trace 0- and 1-unit mini-models, composite per unit.

    mini0 = embed + head only; unit = mini1 - mini0; total = mini0 + unit x repeats.
    ``base`` is the config (default the full one).
    """
    full_cfg = base or get_config(arch)
    repeats = full_cfg.num_pattern_repeats
    mini1 = lower_cell(arch, shape, mesh, cfg=runtime_config(arch, True, 1, full_cfg),
                       device=device)
    if repeats == 1:
        out = dict(mini1)
        out["composite"] = {
            "flops": mini1["flops"],
            "bytes_accessed": mini1["bytes_accessed"],
            "collectives": mini1["collectives"],
            "repeats": 1,
        }
        return out
    mini0 = lower_cell(arch, shape, mesh, cfg=runtime_config(arch, True, 0, full_cfg),
                       device=device)

    def comp(key):
        u = (mini1[key] or 0.0) - (mini0[key] or 0.0)
        return (mini0[key] or 0.0) + max(u, 0.0) * repeats

    coll: Dict[str, float] = {}
    for k in set(mini1["collectives"]) | set(mini0["collectives"]):
        a = mini0["collectives"].get(k, 0.0)
        b = mini1["collectives"].get(k, 0.0)
        coll[k] = a + max(b - a, 0.0) * repeats
    return {
        "mini0": mini0,
        "mini1": mini1,
        "composite": {
            "flops": comp("flops"),
            "bytes_accessed": comp("bytes_accessed"),
            "collectives": coll,
            "repeats": repeats,
        },
    }


# ------------------------------- runner -------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool, with_cost: bool,
             device: str = "cpu") -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(arch, shape_name)
    if not ok:
        return {"skipped": True, "reason": reason}
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rec = main_record(arch, shape, mesh, device)
    rec["devices"] = math.prod(mesh.shape)
    rec["fits"] = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"] <= HBM_BYTES
    if with_cost and not multi_pod:
        rec["cost"] = composite_cost(arch, shape, mesh, device)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (default) or cpu; nothing runs on it")
    args = ap.parse_args()

    key = f"{args.arch}__{args.shape}__{'multipod' if args.multi_pod else 'pod'}"
    out_dir = args.out or os.path.abspath(ARTIFACTS)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, key + ".json")
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, with_cost=not args.no_cost,
                       device=args.device)
        rec["ok"] = not rec.get("skipped", False)
    except Exception as e:  # noqa: BLE001 - recorded, rerun after fix
        rec = {"ok": False, "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()}
    rec["arch"] = args.arch
    rec["shape"] = args.shape
    rec["multi_pod"] = args.multi_pod
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2, default=float)
    status = "SKIP" if rec.get("skipped") else ("OK" if rec["ok"] else "FAIL")
    print(f"[{status}] {key}")
    if rec.get("error"):
        print(rec["error"])
    if rec.get("temp_size_in_bytes") is not None:
        print(f"  arguments + temp GB/device: {rec['argument_size_in_bytes'] / 1e9:.3f} + "
              f"{rec['temp_size_in_bytes'] / 1e9:.3f}  fits 80 GB: {rec['fits']}")
    if rec.get("flops") is not None:
        print(f"  flops (per device): {rec['flops']:.3e}")
    if "cost" in rec:
        c = rec["cost"]["composite"]
        print(f"  composite flops (per device): {c['flops']:.3e}  collectives: "
              f"{ {k: f'{v:.2e}' for k, v in c['collectives'].items()} }")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
