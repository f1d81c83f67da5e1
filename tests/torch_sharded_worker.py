"""One rank of the port's sharded-step check (JAX-free; spawned by
tests/test_torch_sharding.py on a gloo world of 8 CPU processes).

Rank r loads the step's inputs from ``inputs.pt``, builds the (4, 2) smoke
mesh, places the parameters and the batch with the port's rules, takes two
train steps, serves one token on the mesh, saves a checkpoint from the 4x2
mesh and restores it onto a 2x4 one. Rank 0 writes what it saw to
``result.pt``.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.distributed as dist


def run(rank: int, world: int, port: int, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        _run(rank, work)
    finally:
        dist.destroy_process_group()


def _run(rank: int, work: str) -> None:
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed.sharding import (
        batch_shardings,
        cache_shardings,
        distribute_tree,
        full_tree,
        param_shardings,
    )
    from repro_torch.distributed.step import make_serve_step, make_train_step
    from repro_torch.launch.mesh import make_smoke_mesh, set_ambient_mesh
    from repro_torch.models import init_cache
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.tree import leaves

    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    cfg, params, batch = inp["cfg"], inp["params"], inp["batch"]
    mesh = make_smoke_mesh(4, 2, device="cpu")
    set_ambient_mesh(mesh)
    specs = param_shardings(params, mesh)
    p = distribute_tree(params, specs, mesh)
    opt = AdamW(AdamWConfig(lr=inp["lr"]))
    state = opt.init(leaves(p))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    db = distribute_tree(tb, batch_shardings(tb, mesh), mesh)
    step = make_train_step(cfg, opt, accum_steps=inp["accum"], impl="ref")
    losses = []
    for _ in range(2):
        p, state, metrics = step(p, state, db)
        losses.append(float(metrics["loss"].full_tensor()))
    full = full_tree(p)

    serve = make_serve_step(cfg, impl="ref")
    cache = init_cache(cfg, inp["serve_batch"], inp["serve_len"], device="cpu")
    cache = distribute_tree(cache, cache_shardings(cache, mesh, inp["serve_batch"]), mesh)
    tok = {"t": torch.as_tensor(inp["token"])}
    tok = distribute_tree(tok, batch_shardings(tok, mesh), mesh)["t"]
    logits, cache = serve(p, cache, tok, 0)
    logits = logits.full_tensor()

    # elastic restore: written from the 4x2 mesh, restored onto 2x4
    d = tempfile.mkdtemp(dir=work) if rank == 0 else None
    box = [d]
    dist.broadcast_object_list(box, src=0)
    save_checkpoint(box[0], 1, {"params": p})
    mesh2 = make_smoke_mesh(2, 4, device="cpu")
    out = restore_checkpoint(box[0], 1, {"params": params},
                             shardings={"params": param_shardings(params, mesh2)}, mesh=mesh2)
    restored = leaves(out)
    meshes = {tuple(x.device_mesh.shape) for x in restored if isinstance(x, DTensor)}
    equal = all(torch.equal(a.full_tensor(), b) for a, b in zip(restored, leaves(full),
                                                                 strict=True))
    if rank == 0:
        torch.save({"losses": losses, "params": full, "logits": logits, "restored_equal": equal,
                    "restored_meshes": sorted(meshes)}, os.path.join(work, "result.pt"))


if __name__ == "__main__":
    import torch.multiprocessing as mp

    work_dir, port_no = sys.argv[1], int(sys.argv[2])
    mp.spawn(run, args=(8, port_no, work_dir), nprocs=8)
