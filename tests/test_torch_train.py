"""The port's ``loss_fn`` and its gradients against the JAX package's, on the CPU.

For each ported arch at smoke size (gemma3-1b, granite-moe-3b-a800m,
whisper-base, phi-3-vision-4.2b and nemotron-4-340b here; jamba-v0.1-52b, xlstm-350m,
gemma3-12b, mixtral-8x7b and stablelm-3b in tests/test_torch_train_hybrid.py;
gemma3-1b cut to one 6-layer unit), both sides run the same
parameters (the JAX package's ``init_params`` tree, converted with
``params_from_jax``) on the same numpy-made batch (with whisper's frame and
phi-3-vision's patch embeddings, whose gradients flow through the encoder
and cross-attention, or the image positions), at ``impl="ref"`` (the
plain versions, as the reference trains). The JAX side is
``jax.jit(jax.value_and_grad(loss_fn))``; the port's is autograd through
its plain versions, under ``remat="block"`` as the trainer runs it (the
reference runs ``remat="none"``: ``jax.checkpoint`` changes no value).

Tolerances:
* fp32 loss: 1e-5 relative; both sides sum the same fp32 terms in other orders.
* fp32 gradients: every leaf within 1e-4 of its own largest magnitude.
* bf16 loss: 1e-2 relative; bf16 roundings at other places through the layers.
* remat ``"block"`` against ``"none"`` in the port: bit for bit (the
  recomputation repeats the same ops on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import smoke_config
from repro_torch.distributed.step import _value_and_grad
from repro_torch.models import loss_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import flatten_with_paths, path_key

# this file's archs; tests/test_torch_train_hybrid.py runs the same tests on
# the others, on another worker
ARCHS = ["gemma3_1b", "granite_moe_3b_a800m", "whisper_base", "phi3_vision_4_2b", "nemotron_4_340b"]
B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_RTOL = 1e-2
# loss_chunk of the gradient check (4 chunks of 16) and of the two loss-only
# checks: 512 (one chunk of S, as the trainer's default at this S) and 48
# (S is no multiple of it: one chunk of S); the reference's loss at 16 is
# the value both must give, as chunking moves only the order of the sums
GRAD_CHUNK = 16
LOSS_CHUNKS = (512, 48)
# gemma3-1b's smoke config cut from 13 layers to one 6-layer pattern unit (5
# local, 1 global): every layer kind, half the reference's compile time
LAYERS = {"gemma3_1b": 6}


def _cfgs(arch, dtype):
    kw = {"dtype": dtype, "param_dtype": dtype}
    if arch in LAYERS:
        kw["n_layers"] = LAYERS[arch]
    return (dataclasses.replace(jax_smoke_config(arch), remat="none", **kw),
            dataclasses.replace(smoke_config(arch), remat="block", **kw))


def _batch(cfg, seed=0):
    """S text tokens and their labels, and the config's frame or patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder is not None:
        batch["enc_frames"] = rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.vision_tokens:
        batch["img_embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_params(cfg, jparams):
    return params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _cast(jparams, jcfg16):
    """The fp32 parameters rounded to the dtypes of ``jcfg16``'s tree (some
    leaves stay fp32 in a bf16 config: gates, router, the mixer's dt and A)."""
    want = jax.eval_shape(lambda: jax_init_params(jcfg16, seed=0))
    return jax.tree_util.tree_map(lambda p, w: p.astype(w.dtype), jparams, want)


def reference(arch):
    """One arch: configs, params on both sides, the batch, and the reference's
    fp32 loss and gradients and its bf16 loss, from one compiled function."""
    jcfg, cfg = _cfgs(arch, "float32")
    jcfg16, cfg16 = _cfgs(arch, "bfloat16")
    jparams = jax_init_params(jcfg, seed=0)
    jparams16 = _cast(jparams, jcfg16)
    batch = _batch(cfg)

    def reference(p, p16, b):
        vg = jax.value_and_grad(
            lambda q: jax_loss_fn(jcfg, q, b, impl="ref", loss_chunk=GRAD_CHUNK))
        return vg(p), jax_loss_fn(jcfg16, p16, b, impl="ref")

    (jloss, jgrads), jloss16 = jax.jit(reference)(jparams, jparams16, _jax_batch(batch))
    return {
        "arch": arch, "cfg": cfg, "params": _port_params(cfg, jparams), "batch": batch,
        "loss": float(jloss), "grads": jax.tree_util.tree_leaves_with_path(jgrads),
        "cfg16": cfg16, "params16": _port_params(cfg16, jparams16), "loss16": float(jloss16),
    }


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference(request.param)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_fp32_loss_and_every_gradient_match_the_reference(ref):
    loss, grads = _value_and_grad(ref["cfg"], ref["params"], ref["batch"], "ref",
                                  loss_chunk=GRAD_CHUNK)
    assert _rel(float(loss), ref["loss"]) <= LOSS_RTOL, (float(loss), ref["loss"])
    # the port walks the tree in JAX's leaf order, so the lists pair up by path
    want_paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in ref["grads"]]
    assert [path_key(p) for p, _ in flatten_with_paths(ref["params"])] == want_paths
    assert len(grads) == len(want_paths)
    for path, (_, want), got in zip(want_paths, ref["grads"], grads, strict=True):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32, path
        scale = max(float(np.max(np.abs(want))), 1e-30)
        err = float(np.max(np.abs(got.numpy() - want)))
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("i", range(len(LOSS_CHUNKS)), ids=[f"chunk{c}" for c in LOSS_CHUNKS])
def test_fp32_loss_matches_the_reference_in_both_chunking_branches(ref, i):
    with torch.no_grad():
        loss = loss_fn(ref["cfg"], ref["params"], ref["batch"], impl="ref",
                       loss_chunk=LOSS_CHUNKS[i], device="cpu")
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert _rel(float(loss), ref["loss"]) <= LOSS_RTOL


def test_bf16_loss_matches_the_reference(ref):
    with torch.no_grad():
        loss = loss_fn(ref["cfg16"], ref["params16"], ref["batch"], impl="ref", device="cpu")
    assert loss.dtype == torch.float32
    assert _rel(float(loss), ref["loss16"]) <= BF16_RTOL, (float(loss), ref["loss16"])


def test_remat_block_gives_the_bits_of_none(ref):
    cfg = ref["cfg"]
    got = _value_and_grad(cfg, ref["params"], ref["batch"], "ref", loss_chunk=GRAD_CHUNK)
    want = _value_and_grad(dataclasses.replace(cfg, remat="none"), ref["params"], ref["batch"],
                           "ref", loss_chunk=GRAD_CHUNK)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1], strict=True))


def test_remat_block_recomputes_under_autograd_only(monkeypatch):
    """The checkpoint wraps each unit when autograd records, and not in a
    forward without gradients (serving)."""
    import repro_torch.models.transformer as T

    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dataclasses.replace(smoke_config("granite_moe_3b_a800m"), dtype="float32",
                              param_dtype="float32", remat="block")
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    with torch.no_grad():
        loss_fn(cfg, params, batch, impl="ref", device="cpu")
    assert calls == []
    _value_and_grad(cfg, params, batch, "ref")
    assert len(calls) == cfg.num_pattern_repeats

