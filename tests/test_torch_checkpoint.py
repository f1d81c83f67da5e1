"""The port's checkpoint store and data pipeline against the JAX package's, on the CPU.

* ``SyntheticLM``: the same numpy arrays (``==``) for every (seed, step,
  host_index, host_count) tried, modality stubs included; ``make_batch_specs``
  gives the same keys, shapes and dtypes.
* The store: a round trip in the port is bit-exact (bf16, list and tuple
  leaves, an int32 scalar); a shape mismatch raises ``ValueError`` and a
  missing leaf ``KeyError``; the async manager keeps the newest N, snapshots
  before it returns and re-raises its writer's error.
* Both ways: the trainer's ``{"params", "opt"}`` tree written by the
  reference restores in the port bit for bit, and the port's in the
  reference's ``restore_checkpoint``; the manifests hold the same keys.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import make_batch_specs as jax_batch_specs
from repro.models import init_params as jax_init_params
from repro.models.config import EncoderConfig as JaxEncoderConfig
from repro.optim import OptState as JaxOptState
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLM, make_batch_specs
from repro_torch.distributed import from_train_state, train_state
from repro_torch.models import abstract_params
from repro_torch.models.config import EncoderConfig
from repro_torch.models.convert import opt_state_from_jax, params_from_jax, tensor_from_numpy
from repro_torch.optim import OptState
from repro_torch.tree import leaves, unflatten

ARCH = "gemma3_1b"


def _modal_cfgs(kind):
    """(JAX, port) gemma smoke configs, plain or with a vision stub or an encoder."""
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    if kind == "vision":
        return (dataclasses.replace(jcfg, vision_tokens=16),
                dataclasses.replace(cfg, vision_tokens=16))
    if kind == "encoder":
        return (dataclasses.replace(jcfg, encoder=JaxEncoderConfig(n_layers=2, n_frames=32)),
                dataclasses.replace(cfg, encoder=EncoderConfig(n_layers=2, n_frames=32)))
    return jcfg, cfg


# ------------------------------ data ----------------------------------------


@pytest.mark.parametrize("kind", ["text", "vision", "encoder"])
@pytest.mark.parametrize("seed, step, host_index, host_count",
                         [(0, 0, 0, 1), (0, 7, 0, 1), (3, 12, 1, 2), (5, 1, 3, 4)])
def test_synthetic_lm_gives_the_references_arrays(kind, seed, step, host_index, host_count):
    jcfg, cfg = _modal_cfgs(kind)
    want = JaxSyntheticLM(jcfg, 8, 64, seed=seed).shard_for_step(step, host_index, host_count)
    got = SyntheticLM(cfg, 8, 64, seed=seed).shard_for_step(step, host_index, host_count)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    if host_count == 1:
        full = SyntheticLM(cfg, 8, 64, seed=seed).batch_for_step(step)
        assert all(np.array_equal(full[k], want[k]) for k in want)


@pytest.mark.parametrize("for_training", [True, False])
@pytest.mark.parametrize("kind", ["text", "vision", "encoder"])
def test_batch_specs_match_the_references(kind, for_training):
    jcfg, cfg = _modal_cfgs(kind)
    want = jax_batch_specs(jcfg, 4, 64, for_training=for_training)
    got = make_batch_specs(cfg, 4, 64, for_training=for_training)
    assert got.keys() == want.keys()
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape and str(got[k].dtype) == f"torch.{spec.dtype}", k


# ------------------------------ store ---------------------------------------


def _tree():
    return {
        "a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
        "b": [torch.linspace(-3, 3, 7).to(torch.bfloat16), torch.tensor(3, dtype=torch.int32)],
        "c": (torch.ones(2, 2, dtype=torch.float16), torch.tensor([1, -2], dtype=torch.int64)),
    }


def _meta(tree):
    return unflatten(tree, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                            for t in leaves(tree)])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_round_trip_is_bit_exact(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000007" and latest_step(str(tmp_path)) == 7
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["keys"]["b/0"] == {"shape": [7], "dtype": "bfloat16", "shard": 0}
    assert manifest["num_shards"] == 1 and manifest["extra"] == {"note": "x"}
    assert np.load(os.path.join(path, "shard_0000.npz"))["b/0"].dtype == np.uint16
    for target in (tree, _meta(tree)):
        out = restore_checkpoint(str(tmp_path), 7, target, device="cpu")
        assert isinstance(out["c"], tuple) and isinstance(out["b"], list)
        assert all(_same(a, b) for a, b in zip(leaves(out), leaves(tree), strict=True))


def test_restore_casts_to_the_target_dtype(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    target = {**_meta(tree), "b": [torch.empty(7, device="meta"), torch.empty((), device="meta")]}
    out = restore_checkpoint(str(tmp_path), 1, target, device="cpu")
    assert out["b"][0].dtype == torch.float32 and torch.equal(out["b"][0], tree["b"][0].float())
    assert out["b"][1].dtype == torch.float32 and float(out["b"][1]) == 3.0


def test_shards_split_at_the_shard_size(tmp_path, monkeypatch):
    import repro_torch.checkpoint.store as store

    monkeypatch.setattr(store, "_SHARD_BYTES", 40)
    tree = {"a": torch.zeros(8), "b": torch.ones(8), "c": torch.full((2,), 2.0)}
    save_checkpoint(str(tmp_path), 2, tree)
    manifest = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    assert manifest["num_shards"] == 2
    assert [manifest["keys"][k]["shard"] for k in "abc"] == [0, 1, 1]
    out = restore_checkpoint(str(tmp_path), 2, tree, device="cpu")
    assert all(_same(out[k], tree[k]) for k in tree)


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3, 3)}, device="cpu")
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, 2), "u": torch.zeros(1)},
                           device="cpu")


def test_manager_snapshots_keeps_the_newest_and_times(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros(4)
    for s in (1, 2, 3, 4):
        w.fill_(s)
        mgr.save_async(s, {"w": w})
        w.fill_(-1.0)  # the caller overwrites its tensor at once
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    for s in (3, 4):
        out = restore_checkpoint(str(tmp_path), s, {"w": torch.zeros(4)}, device="cpu")
        assert torch.equal(out["w"], torch.full((4,), float(s)))
    assert [t["step"] for t in mgr.timings] == [1, 2, 3, 4]
    assert all(t["snapshot_s"] >= 0 and t["write_s"] > 0 for t in mgr.timings)


def test_manager_reraises_its_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker / "ckpt"))
    mgr.save_async(1, {"w": torch.zeros(1)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # raised once


def test_latest_step_of_a_missing_directory_is_none(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    (tmp_path / "step_00000005.tmp").mkdir()
    assert latest_step(str(tmp_path)) is None


# ------------------------------ both ways -----------------------------------


@pytest.fixture(scope="module")
def trainer_tree():
    """The reference's trainer tree at gemma's smoke config in bf16: params
    from its ``init_params``, a non-zero ``OptState`` made with numpy."""
    jcfg = jax_smoke_config(ARCH)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, seed=0))
    rng = np.random.default_rng(0)
    moments = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams) for _ in range(2)]
    opt = JaxOptState(m=moments[0], v=jax.tree_util.tree_map(np.abs, moments[1]),
                      step=np.asarray(5, np.int32))
    return jcfg, {"params": jparams, "opt": opt}


def _manifest_keys(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["keys"]


def test_reference_checkpoint_restores_in_the_port(tmp_path, trainer_tree):
    jcfg, jtree = trainer_tree
    jax_save(str(tmp_path), 5, jax.tree_util.tree_map(jnp.asarray, jtree))
    cfg = smoke_config(ARCH)
    meta = abstract_params(cfg)
    target = train_state(meta, OptState(
        m=[torch.empty(p.shape, device="meta") for p in leaves(meta)],
        v=[torch.empty(p.shape, device="meta") for p in leaves(meta)],
        step=torch.empty((), dtype=torch.int32, device="meta")))
    params, state = from_train_state(restore_checkpoint(str(tmp_path), 5, target, device="cpu"))
    want_params = params_from_jax(cfg, jtree["params"], device="cpu")
    want_state = opt_state_from_jax(cfg, jtree["opt"], device="cpu")
    assert any(p.dtype == torch.bfloat16 for p in leaves(params))
    assert all(_same(a, b) for a, b in zip(leaves(params), leaves(want_params), strict=True))
    assert all(_same(a, b) for a, b in zip(state.m, want_state.m, strict=True))
    assert all(_same(a, b) for a, b in zip(state.v, want_state.v, strict=True))
    assert _same(state.step, want_state.step)


def test_port_checkpoint_restores_in_the_reference(tmp_path, trainer_tree):
    jcfg, jtree = trainer_tree
    cfg = smoke_config(ARCH)
    params = params_from_jax(cfg, jtree["params"], device="cpu")
    state = opt_state_from_jax(cfg, jtree["opt"], device="cpu")
    save_checkpoint(str(tmp_path / "port"), 5, train_state(params, state))
    jax_save(str(tmp_path / "ref"), 5, jax.tree_util.tree_map(jnp.asarray, jtree))
    assert _manifest_keys(tmp_path / "port", 5) == _manifest_keys(tmp_path / "ref", 5)
    shapes = jax.eval_shape(lambda: jax.tree_util.tree_map(jnp.asarray, jtree))
    out = jax_restore(str(tmp_path / "port"), 5, shapes)
    got, want = jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(jtree)
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()
    # and the port reads its own bf16 leaves back as it wrote them
    one = tensor_from_numpy(jtree["params"]["embed"])
    back = restore_checkpoint(str(tmp_path / "port"), 5, {"params": {"embed": one}}, device="cpu")
    assert _same(back["params"]["embed"], one)
