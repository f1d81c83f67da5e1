"""The port's gemma3-1b model (repro_torch.models) against the JAX package's, on the CPU.

Both sides run the same parameters: the JAX package's ``init_params`` tree,
converted with ``params_from_jax``. The JAX forward reaches its Pallas kernel
in interpret mode; the port's forward reaches the plain attention (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import decode_step, forward, init_cache, init_params, layers
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

ARCH = "gemma3_1b"
B, S = 2, 128
# fp32 logits, port vs JAX: both accumulate in fp32, in different orders
FWD_TOL = 1e-4
# bf16 logits through 13 layers: rounding to bf16 at different places drifts
BF16_ATOL, BF16_RTOL, BF16_TOP1 = 0.5, 0.05, 0.9


def _cfgs(dtype="float32"):
    kw = {"dtype": dtype, "param_dtype": dtype, "remat": "none"}
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def fp32():
    """Configs, converted params, tokens and the JAX forward (interpret) logits."""
    jcfg, cfg = _cfgs("float32")
    jparams = jax_init_params(jcfg, seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, impl="interpret"))(
        jparams, jnp.asarray(tokens)
    )
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "params": params,
            "tokens": tokens, "jlogits": np.asarray(jlogits)}


def test_configs_match_reference():
    for name in ("gemma3_1b", "gemma3-1b"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    cfg = get_config(ARCH)
    assert len(cfg.pattern_unit()) == 26 and cfg.num_pattern_repeats == 1
    assert [i for i, (k, _) in enumerate(cfg.pattern_unit()) if k == "attn"] == [5, 11, 17, 23]


def test_forward_matches_jax(fp32):
    logits, aux = forward(fp32["cfg"], fp32["params"], {"tokens": fp32["tokens"]}, device="cpu")
    assert logits.dtype == torch.float32 and logits.shape == (B, S, fp32["cfg"].vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), fp32["jlogits"], atol=FWD_TOL, rtol=FWD_TOL)


def test_decode_steps_match_jax(fp32):
    jcfg, cfg, tokens = fp32["jcfg"], fp32["cfg"], fp32["tokens"]
    max_len = 96  # global layers keep 96 slots, local layers min(96, window 64)
    jstep = jax.jit(lambda p, c, t, i: jax_decode_step(jcfg, p, c, t, i, impl="ref"))
    jcache = jax_init_cache(jcfg, B, max_len)
    cache = init_cache(cfg, B, max_len, device="cpu")
    for i in range(8):
        tok = tokens[:, i : i + 1]
        jlg, jcache = jstep(fp32["jparams"], jcache, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lg, cache = decode_step(cfg, fp32["params"], cache, tok, i, device="cpu")
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=FWD_TOL, rtol=FWD_TOL)
    jflat, flat = _flat(_numpy_tree(jcache)), _flat(cache)
    assert set(flat) == set(jflat)
    for path, want in jflat.items():
        assert flat[path].shape == want.shape, path
        np.testing.assert_allclose(flat[path].numpy(), want, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=path)


def test_decode_matches_forward(fp32):
    """Prefill-by-decode reproduces the full-sequence logits (tests/test_models.py:59),
    past the window so the local layers' ring buffers wrap."""
    cfg, params = fp32["cfg"], fp32["params"]
    n = 80
    tokens = fp32["tokens"][:1, :n]
    full, _ = forward(cfg, params, {"tokens": tokens}, device="cpu")
    cache = init_cache(cfg, 1, 96, device="cpu")
    steps = []
    for i in range(n):
        lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i, device="cpu")
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_decode_step_routes_the_cache_attention_by_impl(fp32):
    """``impl`` reaches the attention over the cache: ``"cuda"`` asks for K5,
    which CPU tensors cannot take; ``"ref"`` is the plain version, the CPU's
    ``"auto"``."""
    cfg, params, tokens = fp32["cfg"], fp32["params"], fp32["tokens"]
    with pytest.raises(ValueError, match="decode_attention: q lies on cpu"):
        decode_step(cfg, params, init_cache(cfg, B, 16, device="cpu"), tokens[:, :1], 0, impl="cuda",
                    device="cpu")
    steps = {}
    for impl in ("auto", "ref"):
        cache = init_cache(cfg, B, 16, device="cpu")
        steps[impl] = [decode_step(cfg, params, cache, tokens[:, i : i + 1], i, impl=impl, device="cpu")[0]
                       for i in range(3)]
    assert all(torch.equal(a, r) for a, r in zip(steps["auto"], steps["ref"]))


def test_forward_bf16_matches_jax():
    jcfg, cfg = _cfgs("bfloat16")
    jparams = jax_init_params(jcfg, seed=2)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 64)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, impl="ref"))(
        jparams, jnp.asarray(tokens)
    )
    jlogits = np.asarray(jlogits)
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    logits, _ = forward(cfg, params, {"tokens": tokens}, device="cpu")
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=BF16_ATOL, rtol=BF16_RTOL)
    assert np.mean(logits.numpy().argmax(-1) == jlogits.argmax(-1)) >= BF16_TOP1


DTYPES = ["float32", "bfloat16"]
LAYER_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pair(a, dtype):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.standard_normal((2, 16, 4, 32)).astype(np.float32), dtype)
    pos = np.tile(np.arange(100, 116), (2, 1))
    out = layers.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = jax_layers.apply_rope(jx, jnp.asarray(pos), 1e6)
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_norm_matches_jax(dtype, kind):
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((2, 16, 32)).astype(np.float32) * 3 + 1, dtype)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    out = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, tx, kind)
    want = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jx, kind)
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "gelu", "sq_relu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_apply_matches_jax(dtype, activation):
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    shapes = {"w_up": (64, 128), "w_down": (128, 64)}
    if activation in ("geglu", "swiglu"):
        shapes["w_gate"] = (64, 128)
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}
    out = layers.mlp_apply({k: _pair(v, dtype)[1] for k, v in w.items()}, _pair(h, dtype)[1],
                           activation)
    want = jax_layers.mlp_apply({k: _pair(v, dtype)[0] for k, v in w.items()}, _pair(h, dtype)[0],
                                activation)
    # three roundings to the working dtype on the way (two matmuls, the product)
    tol = 5 * LAYER_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_geglu_uses_tanh_gelu():
    """jax.nn.gelu is the tanh form; the erf form differs by ~1e-3 and must not be used."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    port = layers.activation_fn("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


def test_params_from_jax_covers_every_key_path(fp32):
    jflat = _flat(_numpy_tree(fp32["jparams"]))
    flat = _flat(fp32["params"])
    assert set(flat) == set(jflat)
    for path, want in jflat.items():
        assert flat[path].shape == want.shape and flat[path].dtype == torch.float32, path
        assert torch.equal(flat[path], tensor_from_numpy(want)), path
    # the port's own init has the same layout
    own = _flat(init_params(fp32["cfg"], seed=0, device="cpu"))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: a.shape for p, a in jflat.items()}


def test_params_from_jax_rejects_a_wrong_tree(fp32):
    tree = _numpy_tree(fp32["jparams"])
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(fp32["cfg"], missing, device="cpu")
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="/embed"):
        params_from_jax(fp32["cfg"], bad, device="cpu")


@pytest.mark.parametrize("pattern", ["xlstm", "jamba"])
def test_unported_layer_kinds_raise(pattern):
    """Every layer kind of the block patterns is ported now (jamba's mamba
    layers in A.2, xlstm's mLSTM and sLSTM blocks in A.3), so both cases
    build: jamba with a mixer in place of attention, xlstm with one
    self-contained ``block`` (no MLP) in every unit position."""
    cfg = dataclasses.replace(smoke_config(ARCH), block_pattern=pattern, local_global_ratio=None)
    blocks = init_params(cfg, device="cpu")["blocks"]
    if pattern == "jamba":
        assert "mixer" in blocks["u0"] and "norm1" not in blocks["u0"]
        assert any("attn" in p for p in blocks.values())
        return
    assert len(blocks) == len(cfg.pattern_unit())
    assert all(set(p) == {"block"} for p in blocks.values())
