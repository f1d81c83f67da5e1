"""Serving driver: batched greedy decode (counterpart of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch gemma3-1b --full`` serves the full
config on the card; ``--smoke`` (the default) the reduced one. With a
``torch.distributed`` process group it serves on a mesh, as the reference's
does: ``production_mesh=True`` builds the (16, 16) production mesh (a world
of 256 ranks; any other raises, naming that size), otherwise
:func:`make_smoke_mesh` splits the world; parameters and caches are placed by
:func:`param_shardings` and :func:`cache_shardings`. With no process group it
serves on one device. A config too large for one card is cut in depth, to
whole pattern units
(``--arch jamba-v0.1-52b --full --layers 8``, ``--arch mixtral-8x7b --full
--layers 16``, ``--arch nemotron-4-340b --full --layers 6``);
granite-moe-3b-a800m, xlstm-350m, gemma3-12b, stablelm-3b, phi-3-vision-4.2b
and whisper-base fit whole (``--arch gemma3-12b --full``).
On the CPU: ``--smoke --device cpu``.

As the reference's ``serve``, it decodes text tokens only: whisper-base's
decoder runs without ``enc_out`` (its cross-attention sub-layers are skipped)
and phi-3-vision-4.2b without image positions.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    distribute_tree,
    param_shardings,
)
from repro_torch.launch.mesh import entry_mesh
from repro_torch.models import decode_step, init_cache, init_params


def serve(
    arch: str,
    smoke: bool = True,
    batch: int = 4,
    steps: int = 32,
    max_len: int = 128,
    seed: int = 0,
    device: DeviceLike = None,
    verbose: bool = True,
    production_mesh: bool = False,
    n_layers: Optional[int] = None,
) -> float:
    """Decode ``steps`` greedy tokens for ``batch`` streams; returns tokens/s.

    The first step is warm-up and is not timed, as in the reference. Raises
    if the last step's logits are not finite.

    ``n_layers`` replaces the config's depth and must be a multiple of its
    pattern unit. It is the one-card stand-in for the reference's
    ``production_mesh``, which shards a config that one device cannot hold
    (jamba-v0.1-52b's 32 layers are ~103 GB in bf16, mixtral-8x7b's 93.4 GB,
    nemotron-4-340b's 96 682 GB; 8, 16 and 6 layers fit one card).
    """
    if not 1 < steps <= max_len:
        raise ValueError(f"steps must be in (1, max_len={max_len}], got {steps}")
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        unit = len(cfg.pattern_unit())
        if n_layers < 1 or n_layers % unit:
            raise ValueError(
                f"n_layers={n_layers}: {cfg.name} is cut to whole pattern units of {unit} layers"
            )
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = resolve_device(device)
    mesh = entry_mesh(production_mesh, dev)

    params = init_params(cfg, seed=seed, device=dev)
    cache = init_cache(cfg, batch, max_len, device=dev)
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 1)), device=dev)
    if mesh is not None:
        params = distribute_tree(params, param_shardings(params, mesh), mesh)
        cache = distribute_tree(cache, cache_shardings(cache, mesh, batch), mesh)
        tok = distribute_tree({"t": tok}, batch_shardings({"t": tok}, mesh), mesh)["t"]
    # DTensor views fail under inference_mode: a mesh decodes under no_grad
    scope = (torch.inference_mode() if mesh is None
             else contextlib.ExitStack())
    if mesh is not None:
        scope.enter_context(torch.no_grad())
        scope.enter_context(implicit_replication())
    with scope:
        logits, cache = decode_step(cfg, params, cache, tok, 0, device=dev)  # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(1, steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = decode_step(cfg, params, cache, tok, i, device=dev)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        finite = bool(torch.isfinite(logits).all())  # waits for the device
    dt = time.perf_counter() - t0
    if not finite:
        raise FloatingPointError(f"{arch}: non-finite logits after {steps} decode steps")
    tps = batch * (steps - 1) / dt
    if verbose:
        print(f"{arch}: {tps:.1f} tok/s (batch={batch}, {dt / (steps - 1) * 1e3:.1f} ms/step)")
    return tps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (whole pattern units)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    serve(args.arch, smoke=args.smoke, batch=args.batch, steps=args.steps, device=args.device,
          n_layers=args.layers)


if __name__ == "__main__":
    main()
