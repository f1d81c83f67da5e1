"""The JAX package's sharding layer, run in a process of its own for the
port's tests (``python tests/torch_sharding_reference.py PART IN OUT``).

The device count is fixed before jax starts, as the reference's dry-run
fixes it: 512 placeholder CPU devices give the (16, 16), (2, 16, 16) and
(4, 2) meshes of ``specs``, 4 and 8 those of the other parts. Each PART reads its inputs from the JSON or npz file IN and
writes what the reference computes to the JSON file OUT:

* ``specs``       — every leaf's ``param_spec``, ``param_shardings`` in both
  modes, ``batch_shardings`` and ``cache_shardings`` (batch 1 and 128) of
  all ten configs, full and smoke, on the three meshes; the hint sites'
  specs (``"ValueError"`` where the reference's hint raises); whether
  ``hint(x3d, "model")`` raises;
* ``compression`` — ``quantize_int8``, ``dequantize_int8``, ``ef_compress``
  on the inputs, and ``compressed_psum`` over a ``shard_map`` of 4 devices;
* ``dryrun``      — the compiled ``memory_analysis()`` of a smoke train cell
  on the (4, 2) mesh.
"""

import os

import sys  # noqa: E402

# as many placeholder devices as the part's largest mesh
DEVICES = {"specs": 512, "compression": 4, "dryrun": 8}[sys.argv[1]]
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={DEVICES}"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
# (batch, cache length) of the cache specs: decode_32k's and long_500k's
CACHES = ((128, 32_768), (1, 524_288))


def _spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in tuple(s)]


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                    for k in path)


def _mesh(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def specs(_inp):
    from repro.configs import ARCH_IDS, get_config, smoke_config
    from repro.data.pipeline import make_batch_specs
    from repro.distributed import hints
    from repro.distributed.sharding import (
        batch_shardings,
        cache_shardings,
        param_shardings,
        param_spec,
    )
    from repro.models import abstract_params, init_cache

    out = {}
    for arch in ARCH_IDS:
        for size, cfg in (("full", get_config(arch)), ("smoke", smoke_config(arch))):
            params = abstract_params(cfg)
            rec = {"param_spec": {_key(p): _spec(param_spec(p, leaf)) for p, leaf in
                                  jax.tree_util.tree_leaves_with_path(params)}}
            batch = make_batch_specs(cfg, 256, 4096 if size == "full" else 64, True)
            caches = {f"{b}": jax.eval_shape(lambda b=b, L=L: init_cache(
                cfg, b, L if size == "full" else 64)) for b, L in CACHES}
            for mname in MESHES:
                mesh = _mesh(mname)
                for mode in ("train", "serve"):
                    rec[f"params/{mname}/{mode}"] = {
                        _key(p): _spec(s.spec) for p, s in jax.tree_util.tree_leaves_with_path(
                            param_shardings(params, mesh, mode=mode))}
                rec[f"batch/{mname}"] = {k: _spec(s.spec) for k, s in
                                         batch_shardings(batch, mesh).items()}
                for b, cache in caches.items():
                    rec[f"cache/{mname}/{b}"] = {
                        _key(p): _spec(s.spec) for p, s in jax.tree_util.tree_leaves_with_path(
                            cache_shardings(cache, mesh, int(b)))}
            out[f"{arch}/{size}"] = rec

    # the hint sites of a dense config (gemma3-1b at train_4k's microbatch)
    captured = []
    jax.lax.with_sharding_constraint = lambda x, spec: captured.append(_spec(spec)) or x
    sites = {"qkv": ((128, 4096, 4, 256), ("dp", None, "model", None)),
             "kv": ((128, 4096, 1, 256), ("dp", None, "model", None)),
             "residual": ((128, 4096, 1152), ("dp", None, None)),
             "scan_h": ((128, 2048, 16), ("dp", "model")),
             "mlstm_C": ((128, 4, 256, 256), ("dp",))}
    out["hints"] = {}
    for mname in MESHES:
        with jax.set_mesh(_mesh(mname)):
            for site, (shape, axes) in sites.items():
                captured.clear()
                try:  # fewer axes than dims: the reference's strict zip raises
                    hints.hint(jax.ShapeDtypeStruct(shape, jnp.float32), *axes)
                    out["hints"][f"{mname}/{site}"] = captured[0] if captured else None
                except ValueError:
                    out["hints"][f"{mname}/{site}"] = "ValueError"
    with jax.set_mesh(_mesh("4x2")):
        try:
            hints.hint(jnp.zeros((4, 2, 8)), "model")
            out["hint_fault"] = None
        except ValueError as e:
            out["hint_fault"] = str(e)
    return out


def compression(inp):
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compression import (
        compressed_psum,
        dequantize_int8,
        ef_compress,
        quantize_int8,
    )

    data = np.load(inp)
    out = {}
    for name in data.files:
        if not name.startswith("x_"):
            continue
        x = data[name]
        e = data["e_" + name[2:]]
        q, s, pad = quantize_int8(jnp.asarray(x))
        dec, err = ef_compress(jnp.asarray(x), jnp.asarray(e))
        out[name] = {"q": np.asarray(q).tolist(), "scale": np.asarray(s).tolist(), "pad": pad,
                     "deq": np.asarray(dequantize_int8(q, s, pad, x.shape)).tolist(),
                     "ef": np.asarray(dec).tolist(), "ef_err": np.asarray(err).tolist()}
    # compressed_psum over 4 devices: member i holds g[i], e[i]
    g, e = data["psum_g"], data["psum_e"]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("pod",))

    def body(gl, el):
        red, new_e = compressed_psum({"w": gl[0]}, {"w": el[0]}, "pod")
        return red["w"][None], new_e["w"][None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                               out_specs=(P("pod"), P("pod"))))
    red, new_e = fn(jnp.asarray(g), jnp.asarray(e))
    out["psum"] = {"reduced": np.asarray(red).tolist(), "error": np.asarray(new_e).tolist()}
    return out


def dryrun(inp):
    import dataclasses

    from repro.configs import smoke_config
    from repro.launch import dryrun as d
    from repro.launch.shapes import ShapeSpec

    args = json.loads(open(inp).read())
    out = {}
    for arch in args["archs"]:
        cfg = dataclasses.replace(smoke_config(arch), scan_layers=True, remat="block")
        shape = ShapeSpec("t", "train", args["seq"], args["batch"])
        rec = d.lower_cell(arch, shape, _mesh("4x2"), cfg=cfg)
        out[arch] = {k: rec.get(k) for k in ("argument_size_in_bytes", "output_size_in_bytes")}
    return out


if __name__ == "__main__":
    part, inp, dst = sys.argv[1:4]
    result = {"specs": specs, "compression": compression, "dryrun": dryrun}[part](inp)
    with open(dst, "w") as f:
        json.dump(result, f)
