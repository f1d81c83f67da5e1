"""The port's sharding layer (repro_torch.distributed.{sharding,hints},
repro_torch.launch.mesh) against the JAX package's, on the CPU.

* The rules: every leaf of all ten configs, full and smoke, gets the
  reference's ``param_spec``; ``param_shardings`` in both modes,
  ``batch_shardings`` and ``cache_shardings`` (batch 128 and 1) equal the
  reference's on the (16, 16), (2, 16, 16) and (4, 2) meshes. The reference
  runs in a subprocess with 512 placeholder devices
  (tests/torch_sharding_reference.py); the port's rules read only the mesh's
  axis names and sizes and need no process group.
* The hints: the specs the port pins at a dense config's sites equal the
  reference's; where the reference's ``hint`` gets fewer axes than dims
  (``hint(xs, "model")`` on the MoE buffer, the scans' initial states) it
  raises (``zip(..., strict=True)``), the port pads with ``None``.
* The sharded step: the reference helper's configuration (mixtral smoke:
  MoE and a sliding window; global batch 8, sequence 64, accumulation 2), in
  fp32, on an 8-rank gloo world with a (4, 2) mesh
  (tests/torch_sharded_worker.py): two train steps' losses within 1e-5 of the
  port's unsharded steps and of the reference's ``make_train_step``, every
  parameter leaf at tests/test_torch_train_step.py's bars; the serve step's
  logits within 1e-5 of their largest; a checkpoint saved from the 4x2 mesh
  restored onto 2x4 bit for bit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed.step import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.core.rl.batched_train import shard_rollouts
from repro_torch.data.pipeline import SyntheticLM, make_batch_specs
from repro_torch.distributed.hints import hint, hint_spec
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    param_shardings,
    param_spec,
    placements,
    spec_leaves,
)
from repro_torch.distributed.step import make_serve_step, make_train_step
from repro_torch.launch.mesh import make_production_mesh, smoke_mesh_shape
from repro_torch.models import abstract_params, init_cache, init_params
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.tree import flatten_with_paths, leaves, path_key

HERE = os.path.dirname(__file__)
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}
CACHES = ((128, 32_768), (1, 524_288))  # as the reference helper's
LR, ACCUM, B, S = 1e-3, 2, 8, 64
RTOL = 1e-5
PARAM_TOL = 1e-5
GRAD_TOL = 1e-4  # the gradient bar of tests/test_torch_train.py


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32", remat="block")


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """The module's subprocesses, started together at its first test: the
    reference's specs (512 placeholder devices) and the 8-rank gloo world of
    the sharded step, which starts from the port's parameters (the reference
    takes the same numbers in the test)."""
    d = tmp_path_factory.mktemp("sharding")
    (d / "in.json").write_text("{}")
    cfg = _fp32(smoke_config("mixtral_8x7b"))
    token = np.arange(B, dtype=np.int64)[:, None] % cfg.vocab_size
    torch.save({"cfg": cfg, "params": init_params(cfg, seed=0, device="cpu"),
                "batch": SyntheticLM(cfg, B, S, seed=0).batch_for_step(0), "lr": LR,
                "accum": ACCUM, "serve_batch": B, "serve_len": S, "token": token},
               d / "inputs.pt")
    started = {
        "specs": subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sharding_reference.py"),
                                   "specs", str(d / "in.json"), str(d / "specs.json")], env=_env()),
        "world": subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sharded_worker.py"),
                                   str(d), str(_free_port())], env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True),
    }
    yield d, started
    for p in started.values():
        if p.poll() is None:
            p.kill()


def _wait(proc) -> None:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, (out or "")[-4000:]


@pytest.fixture(scope="module")
def ref(procs):
    d, started = procs
    _wait(started["specs"])
    return json.loads((d / "specs.json").read_text())


def _lists(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _cfgs(arch):
    return (("full", get_config(arch)), ("smoke", smoke_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_of_every_leaf_equals_the_references(ref, arch):
    for size, cfg in _cfgs(arch):
        got = {path_key(p): _lists(param_spec(p, leaf))
               for p, leaf in flatten_with_paths(abstract_params(cfg))}
        assert got == ref[f"{arch}/{size}"]["param_spec"], (arch, size)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_in_both_modes_equal_the_references(ref, arch):
    for size, cfg in _cfgs(arch):
        params = abstract_params(cfg)
        for mname, mesh in MESHES.items():
            for mode in ("train", "serve"):
                specs = param_shardings(params, mesh, mode=mode)
                got = {path_key(p): _lists(s) for (p, _), s in
                       zip(flatten_with_paths(params), _spec_list(specs), strict=True)}
                assert got == ref[f"{arch}/{size}"][f"params/{mname}/{mode}"], (size, mname, mode)


def _spec_list(specs):
    return spec_leaves(specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shardings_equal_the_references(ref, arch):
    for size, cfg in _cfgs(arch):
        batch = make_batch_specs(cfg, 256, 4096 if size == "full" else 64, True)
        with FakeTensorMode():  # shapes only: a full config's cache holds no memory
            caches = {b: init_cache(cfg, b, L if size == "full" else 64, device="cpu")
                      for b, L in CACHES}
        for mname, mesh in MESHES.items():
            got = {k: _lists(s) for k, s in batch_shardings(batch, mesh).items()}
            assert got == ref[f"{arch}/{size}"][f"batch/{mname}"], (size, mname)
            for b, cache in caches.items():
                specs = cache_shardings(cache, mesh, b)
                got = {path_key(p): _lists(s) for (p, _), s in
                       zip(flatten_with_paths(cache), _spec_list(specs), strict=True)}
                assert got == ref[f"{arch}/{size}"][f"cache/{mname}/{b}"], (size, mname, b)


SITES = {"qkv": ((128, 4096, 4, 256), ("dp", None, "model", None)),
         "kv": ((128, 4096, 1, 256), ("dp", None, "model", None)),
         "residual": ((128, 4096, 1152), ("dp", None, None)),
         "scan_h": ((128, 2048, 16), ("dp", "model")),
         "mlstm_C": ((128, 4, 256, 256), ("dp",))}


def test_hint_specs_at_the_dense_sites_equal_the_references(ref):
    """gemma3-1b's attention and residual sites on all three meshes; at the
    scans' states (fewer axes than dims) the reference raises and the port
    pads the trailing dims with None."""
    for mname, sizes in MESHES.items():
        for site, (shape, axes) in SITES.items():
            got = _lists(hint_spec(shape, axes, sizes))
            want = ref["hints"][f"{mname}/{site}"]
            if want == "ValueError":
                assert got[len(axes):] == [None] * (len(shape) - len(axes)), (mname, site)
                assert got[: len(axes)] == _lists(hint_spec(shape[: len(axes)], axes, sizes))
            else:
                assert got == want, (mname, site)


def test_the_references_hint_fault_and_the_ports_padding(ref):
    """ROADMAP.md C: the reference's ``hint(x3d, "model")`` raises under a
    mesh (``repro/distributed/hints.py:42`` zips strictly; ``repro/models/moe.py:116``
    calls it so), which is why tests/test_distributed_smoke.py's sharded smoke
    fails; the port pins ("model", None, None), as the reference's
    docstring and its own padding at ``:55`` intend."""
    assert ref["hint_fault"] is not None and "zip()" in ref["hint_fault"]
    assert hint_spec((4, 2, 8), ("model",), MESHES["4x2"]) == ("model", None, None)
    x = torch.zeros(4, 2, 8)
    assert hint(x, "model") is x  # no mesh, no DTensor: a no-op


def test_placements_of_a_spec():
    mesh3 = MESHES["2x16x16"]
    assert placements((("pod", "data"), None, "model"), mesh3) == (Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), MESHES["4x2"]) == (Shard(1), Replicate())
    assert placements((), MESHES["16x16"]) == (Replicate(), Replicate())


def test_meshes_need_their_world_and_split_it_as_the_reference():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    for n in (1, 2, 4, 8, 12, 256, 512):  # repro.launch.mesh.make_smoke_mesh's loop
        data, model = n, 1
        while data % 2 == 0 and model < data:
            data //= 2
            model *= 2
        assert smoke_mesh_shape(n) == (data, model)
    assert smoke_mesh_shape(8, 4, 2) == (4, 2)


def test_shard_rollouts_is_the_identity_on_one_device():
    tree = (torch.zeros(6, 3), torch.ones(6))
    assert shard_rollouts(tree) is tree


# ------------------------------ the sharded step -----------------------------


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.float().numpy() - want)))
    assert err <= tol * scale, (what, err, scale)


def _to_jax(like, params):
    """The port's parameters in the reference's tree (its key paths are the port's)."""
    flat = {path_key(p): v for p, v in flatten_with_paths(params)}

    def leaf(path, _):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        return jax.numpy.asarray(flat[key].numpy())

    return jax.tree_util.tree_map_with_path(leaf, like)


def test_sharded_train_serve_and_elastic_restore_on_a_gloo_world(procs):
    d, started = procs
    inp = torch.load(d / "inputs.pt", weights_only=False)
    arch = "mixtral_8x7b"
    jcfg, cfg = _fp32(jax_smoke_config(arch)), inp["cfg"]
    batch, params0, token = inp["batch"], inp["params"], inp["token"]

    # the reference's single-device steps from the same numbers
    jopt = JaxAdamW(JaxAdamWConfig(lr=LR))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, accum_steps=ACCUM, impl="ref"))
    jp = _to_jax(jax_init_params(jcfg, seed=0), params0)
    js = jopt.init(jp)
    jlosses, moments = [], []
    for _ in range(2):
        jp, js, m = jstep(jp, js, batch)
        jlosses.append(float(m["loss"]))
        moments.append({path_key(k): np.asarray(v) for k, v in flatten_with_paths(js.m)})
    # each step's gradient, up to a factor, from the reference's first moment
    g1 = moments[0]
    g2 = {k: moments[1][k] - 0.9 * moments[0][k] for k in g1}

    # the port's unsharded steps
    opt = AdamW(AdamWConfig(lr=LR))
    step = make_train_step(cfg, opt, accum_steps=ACCUM, impl="ref")
    p, state = params0, opt.init(leaves(params0))
    losses = []
    for _ in range(2):
        p, state, m = step(p, state, batch)
        losses.append(float(m["loss"]))
    cache = init_cache(cfg, B, S, device="cpu")
    logits, _ = make_serve_step(cfg, impl="ref")(p, cache, torch.as_tensor(token), 0)

    _wait(started["world"])
    res = torch.load(d / "result.pt", weights_only=False)

    for got, port, want in zip(res["losses"], losses, jlosses, strict=True):
        assert abs(got - port) <= RTOL * abs(port), (res["losses"], losses)
        assert abs(got - want) <= RTOL * abs(want), (res["losses"], jlosses)
    # every leaf at the train-step bars: 1e-5 of its largest, 2 * lr where
    # either step's gradient is within the gradient bar of 0 (Adam divides it
    # out: at the first step it moves such an element by lr times its sign)
    for (path, got), want in zip(flatten_with_paths(res["params"]), leaves(p), strict=True):
        diff = np.abs(got.numpy() - want.numpy())
        scale = max(float(np.max(np.abs(want.numpy()))), 1e-30)
        noise = np.zeros(diff.shape, dtype=bool)
        for g in (g1, g2):
            gk = g[path_key(path)]
            noise |= np.abs(gk) <= GRAD_TOL * float(np.max(np.abs(gk)))
        assert float(np.max(np.where(noise, 0.0, diff))) <= PARAM_TOL * scale, path
        assert float(np.max(np.where(noise, diff, 0.0))) <= 2 * LR, path
    _close(res["logits"], logits.numpy(), 1e-5, "serve logits")
    assert res["restored_equal"] and res["restored_meshes"] == [(2, 4)]

