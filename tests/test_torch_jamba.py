"""The port's jamba path (mamba mixer, MoE, hybrid blocks) against the JAX package's, on the CPU.

Both sides run the same parameters (the JAX package's, converted with
``params_from_jax``) and the same numpy-made inputs. The JAX side reaches its
Pallas kernels in interpret mode, as its own tests do; the port's side runs
the plain versions, which its dispatch picks for CPU tensors.

Tolerances:
* fp32 layers and the fp32 model: 1e-5 per layer and 1e-4 for logits after
  16 layers; both sides compute in fp32 and differ only in summation order.
* bf16: the causal conv sums four taps in bf16 on both sides, so they agree to
  a bf16 rounding of the sum (2 ulp, 1e-2 relative); one bf16 MoE layer
  rounds at the same places as the reference (``up``/``gate`` stay fp32), so
  it agrees to 1e-2 (one bf16 ulp of its output, from fp32 sums taken in
  another order); whole bf16 models, where such ulps reach the router and
  the next layers, are held to top-1 agreement >= 0.9, as the gemma3-1b
  slice is.
* MoE dispatch is integer work: the same copies are kept and dropped on both
  sides, so fp32 outputs agree to 1e-5 even when capacity drops copies.
* decode against forward: the bar of tests/test_models.py::test_decode_matches_forward
  (2e-2), at capacity factor 8 as there: forward's capacity cut depends on
  the load and per-token decode has none.
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
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import mamba, moe, xlstm
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

ARCH = "jamba_v01_52b"
B, S = 2, 64
LAYER_TOL = 1e-5
FWD_TOL = 1e-4
DECODE_VS_FORWARD_TOL = 2e-2
BF16_TOP1 = 0.9


def _cfgs(dtype="float32", **kw):
    """(JAX, port) smoke configs at 16 layers: two repeats of the 8-layer unit."""
    kw = {"n_layers": 16, "dtype": dtype, "param_dtype": dtype, "remat": "none", **kw}
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


def _with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair(a, dtype):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def fp32():
    """Configs, converted params, tokens and the JAX forward (Pallas interpret) outputs."""
    jcfg, cfg = _cfgs("float32")
    jparams = jax_init_params(jcfg, seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jaux = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, impl="interpret"))(
        jparams, jnp.asarray(tokens)
    )
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "params": params, "tokens": tokens,
            "jlogits": np.asarray(jlogits), "jaux": float(jaux)}


# ------------------------------- configs -----------------------------------


def test_configs_match_reference():
    for name in ("jamba_v01_52b", "jamba-v0.1-52b"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    cfg = get_config(ARCH)
    unit = cfg.pattern_unit()
    assert len(unit) == 8 and cfg.num_pattern_repeats == 4
    assert [k for k, _ in unit] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [i for i, (_, moe_) in enumerate(unit) if moe_] == [1, 3, 5, 7]


# ------------------------------ causal conv --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 37, 48)).astype(np.float32), dtype)
    jw, tw = _pair((rng.standard_normal((4, 48)) * 0.5).astype(np.float32), dtype)
    out = xlstm._causal_conv(tw, tx)
    assert out.dtype == tx.dtype
    want = np.asarray(jax_xlstm._causal_conv(jw, jx), np.float32)
    tol = LAYER_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_f32(out), want, atol=tol, rtol=tol)


def test_conv_init_layout():
    gen = torch.Generator().manual_seed(0)
    w = xlstm._conv_init(gen, xlstm.CONV, 48, torch.bfloat16, "cpu", lead=(3,))
    assert w.shape == (3, 4, 48) and w.dtype == torch.bfloat16
    assert float(w.float().abs().max()) <= 2.0 / np.sqrt(4) + 1e-6


# --------------------------------- MoE -------------------------------------


def _moe_case(factor, dtype="float32", seed=3):
    jcfg, cfg = _cfgs(dtype)
    jcfg, cfg = _with_capacity(jcfg, factor), _with_capacity(cfg, factor)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg, getattr(jnp, dtype))
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(jp), x


def _max_group(cfg, p, x):
    """The largest number of token copies routed to one expert."""
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model) @ p["router"], -1)
    top_e = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    return int(torch.bincount(top_e.reshape(-1), minlength=cfg.moe.num_experts).max())


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_apply_matches_jax(factor):
    jcfg, cfg, jp, p, x = _moe_case(factor)
    capacity = int(np.ceil(B * S * cfg.moe.top_k / cfg.moe.num_experts * factor))
    if factor < 1:  # the case exists to drop copies: make sure it does
        assert _max_group(cfg, p, x) > capacity
    out, aux = moe.moe_apply(p, cfg, torch.from_numpy(x))
    jout, jaux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LAYER_TOL)


def test_moe_apply_bf16_matches_jax():
    """bf16: up/gate stay fp32 up to the activation on both sides, so outputs
    agree to one bf16 ulp; dispatch is the same."""
    jcfg, cfg, jp, p, x = _moe_case(1.25, "bfloat16", seed=4)
    jx, tx = _pair(x, "bfloat16")
    out, aux = moe.moe_apply(p, cfg, tx)
    jout, jaux = jax_moe.moe_apply(jp, jcfg, jx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), np.asarray(jout, np.float32), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LAYER_TOL)


def test_moe_decode_sized_batch_matches_jax():
    """Decode runs the MoE over B tokens of one step: capacity ceil(B*k/E*cf)."""
    jcfg, cfg, jp, p, x = _moe_case(1.25, seed=5)
    out, _ = moe.moe_apply(p, cfg, torch.from_numpy(x[:, :1]))
    jout, _ = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x[:, :1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=LAYER_TOL, rtol=LAYER_TOL)


# ----------------------------- mamba mixer ---------------------------------


@pytest.fixture(scope="module")
def mixer():
    jcfg, cfg = _cfgs("float32")
    jp = jax_mamba.mamba_init(jax.random.PRNGKey(6), jcfg, jnp.float32)
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(jp), x


def test_mamba_init_layout(mixer):
    jcfg, cfg, jp, p, _ = mixer
    gen = torch.Generator().manual_seed(0)
    own = mamba.mamba_init(gen, cfg, torch.float32, "cpu", lead=(2,))
    flat, want = _flat(own), _flat(p)
    assert set(flat) == set(want)
    for k, t in flat.items():
        assert t.shape == (2, *want[k].shape) and t.dtype == want[k].dtype, k
    np.testing.assert_allclose(own["log_a"][1].numpy(), p["log_a"].numpy())  # S4D-real, exact
    dt = torch.nn.functional.softplus(own["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)


def test_mamba_apply_matches_jax(mixer):
    jcfg, cfg, jp, p, x = mixer
    out = mamba.mamba_apply(p, cfg, torch.from_numpy(x))
    want = jax_mamba.mamba_apply(jp, jcfg, jnp.asarray(x), impl="interpret")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=LAYER_TOL, rtol=LAYER_TOL)


def test_mamba_decode_matches_jax(mixer):
    """One step from a non-zero state: output, h and conv window."""
    jcfg, cfg, jp, p, x = mixer
    rng = np.random.default_rng(7)
    st = jax_mamba.mamba_state_init(jcfg, B, jnp.float32)
    st = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32) for k, v in st.items()}
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    out, state = mamba.mamba_decode(p, cfg, torch.from_numpy(x[:, :1]), state)
    jout, jst = jax_mamba.mamba_decode(jp, jcfg, jnp.asarray(x[:, :1]),
                                       {k: jnp.asarray(v) for k, v in st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=LAYER_TOL, rtol=LAYER_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jst[k]), atol=LAYER_TOL,
                                   rtol=LAYER_TOL, err_msg=k)


def test_mamba_state_init_layout():
    jcfg, cfg = _cfgs("bfloat16")
    st = mamba.mamba_state_init(cfg, 3, torch.bfloat16, "cpu", lead=(2,))
    jst = jax_mamba.mamba_state_init(jcfg, 3, jnp.bfloat16)
    for k in ("h", "conv"):
        assert st[k].shape == (2, *jst[k].shape), k
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == torch.bfloat16


# ------------------------------ whole model --------------------------------


def test_forward_matches_jax(fp32):
    logits, aux = forward(fp32["cfg"], fp32["params"], {"tokens": fp32["tokens"]}, device="cpu")
    assert logits.dtype == torch.float32 and logits.shape == (B, S, fp32["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), fp32["jlogits"], atol=FWD_TOL, rtol=FWD_TOL)
    assert fp32["jaux"] > 0
    np.testing.assert_allclose(float(aux), fp32["jaux"], atol=FWD_TOL, rtol=FWD_TOL)


def test_decode_steps_match_jax(fp32):
    jcfg, cfg, tokens = fp32["jcfg"], fp32["cfg"], fp32["tokens"]
    max_len = 32
    jstep = jax.jit(lambda p, c, t, i: jax_decode_step(jcfg, p, c, t, i, impl="ref"))
    jcache = jax_init_cache(jcfg, B, max_len)
    cache = init_cache(cfg, B, max_len, device="cpu")
    for i in range(4):
        tok = tokens[:, i : i + 1]
        jlg, jcache = jstep(fp32["jparams"], jcache, jnp.asarray(tok), jnp.asarray(i, jnp.int32))
        lg, cache = decode_step(cfg, fp32["params"], cache, tok, i, device="cpu")
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=FWD_TOL, rtol=FWD_TOL)
    jflat, flat = _flat(_numpy_tree(jcache)), _flat(cache)
    assert set(flat) == set(jflat)
    assert {p.rsplit("/", 1)[1] for p in flat} == {"k", "v", "h", "conv"}
    for path, want in jflat.items():
        assert flat[path].shape == want.shape, path
        np.testing.assert_allclose(flat[path].numpy(), want, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=path)


def test_decode_matches_forward(fp32):
    """Prefill-by-decode reproduces the full-sequence logits, with capacity to spare."""
    cfg = _with_capacity(fp32["cfg"], 8.0)
    params, n = fp32["params"], 16
    tokens = fp32["tokens"][:1, :n]
    full, _ = forward(cfg, params, {"tokens": tokens}, device="cpu")
    cache = init_cache(cfg, 1, 32, device="cpu")
    steps = []
    for i in range(n):
        lg, cache = decode_step(cfg, params, cache, tokens[:, i : i + 1], i, device="cpu")
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=DECODE_VS_FORWARD_TOL, rtol=DECODE_VS_FORWARD_TOL)


def test_forward_bf16_matches_jax():
    jcfg, cfg = _cfgs("bfloat16")
    jparams = jax_init_params(jcfg, seed=2)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, impl="ref"))(
        jparams, jnp.asarray(tokens)
    )
    jlogits = np.asarray(jlogits)
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    assert params["blocks"]["u1"]["moe"]["w_up"].dtype == torch.bfloat16
    logits, aux = forward(cfg, params, {"tokens": tokens}, device="cpu")
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert np.mean(logits.numpy().argmax(-1) == jlogits.argmax(-1)) >= BF16_TOP1


def test_params_from_jax_covers_every_key_path(fp32):
    jflat = _flat(_numpy_tree(fp32["jparams"]))
    flat = _flat(fp32["params"])
    assert set(flat) == set(jflat)
    assert any("/mixer/" in p for p in flat) and any("/moe/" in p for p in flat)
    for path, want in jflat.items():
        assert flat[path].shape == want.shape and flat[path].dtype == torch.float32, path
        assert torch.equal(flat[path], tensor_from_numpy(want)), path
    # the port's own init has the same layout, dtypes included
    own = _flat(init_params(fp32["cfg"], seed=0, device="cpu"))
    assert {p: (tuple(t.shape), t.dtype) for p, t in own.items()} == {
        p: (a.shape, torch.float32) for p, a in jflat.items()
    }


# -------------------------------- serve -------------------------------------


def test_serve_jamba_smoke_on_cpu():
    tps = serve(ARCH, smoke=True, steps=4, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0
    tps = serve("jamba-v0.1-52b", smoke=True, steps=3, n_layers=16, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0


@pytest.mark.parametrize("n_layers", [12, 0])
def test_serve_cuts_only_whole_units(n_layers):
    with pytest.raises(ValueError, match="whole pattern units of 8"):
        serve(ARCH, smoke=True, n_layers=n_layers, device="cpu")
