#!/usr/bin/env python3
"""The port's sharding layer on four CUDA cards: one NCCL world, a 2x2 mesh.

``python3 scripts/torch_sharded_cards.py`` (from the repo root, on a machine
with 4 cards) takes two train steps of the mixtral-8x7b and gemma3-1b smoke
configs (fp32, global batch 8, sequence 64, 2 microbatches) on the mesh and
the same steps without one on each rank's card, serves one token both ways,
saves a checkpoint from the 2x2 mesh and restores it onto a 4x1 one. Rank 0
prints one JSON line: the losses, the largest parameter difference (of its
leaf's largest), the serve logits' difference, whether the restore is bit
for bit, the seconds of a sharded step.
"""

import dataclasses
import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

CARDS = 4
ARCHS = ("mixtral_8x7b", "gemma3_1b")
B, S, ACCUM, LR = 8, 64, 2, 1e-3


def _arch(arch: str, rank: int, work: str) -> dict:
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (
        batch_shardings,
        cache_shardings,
        distribute_tree,
        full_tree,
        param_shardings,
    )
    from repro_torch.distributed.step import make_serve_step, make_train_step
    from repro_torch.launch.mesh import make_smoke_mesh, set_ambient_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.tree import leaves

    dev = f"cuda:{rank}"
    set_ambient_mesh(None)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32", param_dtype="float32",
                              remat="block")
    params = init_params(cfg, seed=0, device=dev)
    opt = AdamW(AdamWConfig(lr=LR))
    step = make_train_step(cfg, opt, accum_steps=ACCUM, impl="ref")
    batch = SyntheticLM(cfg, B, S, seed=0).batch_for_step(0)
    p, state, plain = params, opt.init(leaves(params)), []
    for _ in range(2):
        p, state, m = step(p, state, batch)
        plain.append(float(m["loss"]))
    tok = torch.arange(B, device=dev)[:, None] % cfg.vocab_size
    serve = make_serve_step(cfg, impl="ref")
    with torch.no_grad():
        want, _ = serve(p, init_cache(cfg, B, S, device=dev), tok, 0)

    mesh = make_smoke_mesh(2, 2)
    set_ambient_mesh(mesh)
    dp = distribute_tree(params, param_shardings(params, mesh), mesh)
    ds = opt.init(leaves(dp))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    db = distribute_tree(tb, batch_shardings(tb, mesh), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = []
    for _ in range(2):
        dp, ds, m = step(dp, ds, db)
        sharded.append(float(m["loss"].full_tensor()))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    full = full_tree(dp)
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(leaves(full), leaves(p), strict=True))
    cache = init_cache(cfg, B, S, device=dev)
    cache = distribute_tree(cache, cache_shardings(cache, mesh, B), mesh)
    dtok = distribute_tree({"t": tok}, batch_shardings({"t": tok}, mesh), mesh)["t"]
    with torch.no_grad():
        got, _ = serve(dp, cache, dtok, 0)
    got = got.full_tensor()

    box = [tempfile.mkdtemp(dir=work) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    save_checkpoint(box[0], 1, {"params": dp})
    mesh2 = make_smoke_mesh(4, 1)
    restored = restore_checkpoint(box[0], 1, {"params": params},
                                  shardings={"params": param_shardings(params, mesh2)}, mesh=mesh2)
    equal = all(torch.equal(a.full_tensor(), b)
                for a, b in zip(leaves(restored), leaves(full), strict=True))
    return {"plain_losses": plain, "sharded_losses": sharded, "max_param_rel_err": rel,
            "serve_rel_err": float((got - want).abs().max() / want.abs().max()),
            "restore_2x2_to_4x1_bitwise": equal, "sharded_step_s": step_s}


def _rank(rank: int, port: int, work: str) -> None:
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=CARDS)
    try:
        out = {arch: _arch(arch, rank, work) for arch in ARCHS}
        if rank == 0:
            print(json.dumps({"sharded_cards": out}), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if torch.cuda.device_count() < CARDS:
        print(f"needs {CARDS} CUDA cards; this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout, flush=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_rank, args=(port, tempfile.mkdtemp()), nprocs=CARDS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
