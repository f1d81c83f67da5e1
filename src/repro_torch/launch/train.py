"""Training driver on one card (counterpart of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch gemma3-1b --smoke --device cpu
--steps 40`` trains the reduced config on the CPU; ``--arch gemma3-1b --full``
the full config on the card. What it exercises: deterministic restart-safe
data (:class:`~repro_torch.data.SyntheticLM`), the train step at
``impl="ref"`` with ``remat="block"``, async checkpoints every
``ckpt_every`` steps, resume from the newest checkpoint, loss logging. The
batches carry whisper-base's frame and phi-3-vision-4.2b's patch embeddings
(``--arch whisper-base --smoke --device cpu``).

With a ``torch.distributed`` process group the trainer runs on a mesh, as the
reference's does: ``production_mesh=True`` builds the (16, 16) production
mesh (a world of 256 ranks; any other raises, naming that size), otherwise
:func:`make_smoke_mesh` splits the world. Parameters and optimiser state are
placed by :func:`param_shardings`, each rank makes its data-parallel rows of
the batch (``SyntheticLM.shard_for_step``), checkpoints are gathered whole
and restore onto any mesh. With no process group it runs on one device, with
no mesh, as before.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (
    batch_shardings,
    distribute_tree,
    mesh_sizes,
    param_shardings,
    placements,
)
from repro_torch.distributed.step import from_train_state, make_train_step, train_state
from repro_torch.launch.mesh import entry_mesh
from repro_torch.models import init_params
from repro_torch.optim import AdamW, AdamWConfig, OptState, linear_warmup_cosine
from repro_torch.tree import leaves, unflatten

__all__ = ["train", "main"]


def _meta(tree):
    """``tree`` as meta tensors: the restore's target, holding no memory."""
    return unflatten(tree, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                            for t in leaves(tree)])


def _batch(data: SyntheticLM, step: int, mesh):
    """The step's batch: whole with no mesh; on a mesh each rank makes its
    data-parallel rows (``shard_for_step``, one host per DP coordinate) and
    they are joined as DTensors sharded over the DP axes."""
    if mesh is None:
        return data.batch_for_step(step)
    names = list(mesh_sizes(mesh))
    dp = [i for i, a in enumerate(names) if a != "model"]
    hosts = math.prod(mesh.size(i) for i in dp)
    if data.global_batch % hosts:
        whole = {k: torch.as_tensor(v, device=mesh.device_type)
                 for k, v in data.batch_for_step(step).items()}
        return distribute_tree(whole, batch_shardings(whole, mesh), mesh)
    coord = mesh.get_coordinate()
    host = 0
    for i in dp:
        host = host * mesh.size(i) + coord[i]
    local = data.shard_for_step(step, host, hosts)
    dp_axes = tuple(names[i] for i in dp)
    pl = placements((dp_axes if len(dp_axes) > 1 else dp_axes[0],), mesh)
    return {k: DTensor.from_local(torch.as_tensor(v, device=mesh.device_type), mesh, pl,
                                  run_check=False) for k, v in local.items()}


def _scalar(x) -> float:
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def train(
    arch: str,
    steps: int = 100,
    smoke: bool = True,
    global_batch: int = 8,
    seq_len: int = 256,
    accum_steps: int = 1,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    seed: int = 0,
    production_mesh: bool = False,
    log_every: int = 10,
    verbose: bool = True,
    device: DeviceLike = None,
    stats: Optional[Dict] = None,
):
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s newest checkpoint);
    returns ``(params, losses)``, the losses of the steps this call ran.

    ``stats``, if given, is filled with the wall seconds of each step
    (``step_s``, up to the loss reaching the host), of the restore
    (``restore_s``) and the checkpoint manager's ``timings``.
    """
    cfg = smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, scan_layers=True, remat="block")
    dev = resolve_device(device)
    mesh = entry_mesh(production_mesh, dev)

    opt = AdamW(AdamWConfig(lr=linear_warmup_cosine(lr, max(steps // 20, 1), steps)))
    step_fn = make_train_step(cfg, opt, accum_steps=accum_steps, impl="ref")

    params = init_params(cfg, seed=seed, device=dev)
    specs = None
    if mesh is not None:
        specs = param_shardings(params, mesh)
        params = distribute_tree(params, specs, mesh)
    opt_state = opt.init(leaves(params))

    data = SyntheticLM(cfg, global_batch, seq_len, seed=seed)
    start_step = 0
    manager = None
    stats = {} if stats is None else stats
    stats.update(step_s=[], restore_s=None)
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir)
        stats["timings"] = manager.timings
        last = latest_step(ckpt_dir)
        if last is not None:
            t0 = time.perf_counter()
            target = _meta(train_state(params, opt_state))
            del params, opt_state  # freed before the restore allocates their successors
            # the state's specs: m and v mirror the parameters', the step replicated
            state_specs = None if specs is None else {
                "params": specs, "opt": OptState(m=specs, v=specs, step=())}
            params, opt_state = from_train_state(
                restore_checkpoint(ckpt_dir, last, target, state_specs, mesh=mesh, device=dev))
            stats["restore_s"] = time.perf_counter() - t0
            start_step = last
            if verbose:
                print(f"resumed from step {last}")

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, _batch(data, step, mesh))
        losses.append(_scalar(metrics["loss"]))
        stats["step_s"].append(time.perf_counter() - t_step)
        if verbose and (step + 1) % log_every == 0:
            dt = (time.time() - t0) / max(step + 1 - start_step, 1)
            print(
                f"step {step + 1}/{steps} loss={losses[-1]:.4f} "
                f"gnorm={_scalar(metrics['grad_norm']):.3f} ({dt * 1e3:.0f} ms/step)"
            )
        if manager and (step + 1) % ckpt_every == 0:
            manager.save_async(step + 1, train_state(params, opt_state))
    if manager:
        manager.wait()
    return params, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    _, losses = train(
        args.arch,
        steps=args.steps,
        smoke=args.smoke,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        accum_steps=args.accum_steps,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        production_mesh=args.production_mesh,
        device=args.device,
    )
    n = max(len(losses) // 10, 1)
    print(f"first-{n} loss {np.mean(losses[:n]):.4f} -> last-{n} {np.mean(losses[-n:]):.4f}")


if __name__ == "__main__":
    main()
