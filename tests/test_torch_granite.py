"""The port's granite-moe path (grouped matmul, MoE through it, the model) against the JAX package's, on the CPU.

Both sides run the same parameters (the JAX package's, converted with
``params_from_jax``) and the same numpy-made inputs. The JAX side reaches its
Pallas kernels in interpret mode, as its own tests do; the port's side runs
the plain versions, which its dispatch picks for CPU tensors.

Tolerances:
* ``gmm`` in fp32: 1e-3, the bar of tests/test_kernels.py::test_gmm_matches_oracle;
  both sides sum K products of N(0, 1) values in fp32, in other orders.
* ``gmm`` with bf16 inputs and bf16 output: 1e-2 relative, one bf16 ulp
  (2^-8) of the output and some: both round one fp32 sum, taken in another
  order, so an output that lies near a rounding boundary may round the other
  way. With fp32 output (``out_dtype``) the sums of exact bf16 x bf16
  products are compared at the fp32 bar, 1e-3.
* MoE layers in fp32: 1e-5; dispatch is integer work, so the same copies are
  kept and dropped on both sides, and the products differ only in summation
  order. One bf16 MoE layer: 1e-2, one bf16 ulp of its output, as in
  tests/test_torch_jamba.py (``up``/``gate`` stay fp32 on both sides).
* the fp32 model: 1e-4 for logits after 4 layers, as the other slices.
* bf16 whole models: top-1 agreement >= 0.9, as the other slices: bf16 ulps
  from sums taken in another order reach the router and the next layers.
* decode against forward: the bar of tests/test_models.py::test_decode_matches_forward
  (2e-2), at capacity factor 8 as there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.gmm import gmm as jax_gmm
from repro.kernels.ref import gmm_ref as jax_gmm_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gmm_ref
from repro_torch.launch.serve import serve
from repro_torch.models import abstract_params, decode_step, forward, init_cache, init_params, moe
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

ARCH = "granite_moe_3b_a800m"
B, S = 2, 64
N_LAYERS = 4
GMM_TOL = 1e-3
BF16_TOL = 1e-2
LAYER_TOL = 1e-5
FWD_TOL = 1e-4
DECODE_VS_FORWARD_TOL = 2e-2
BF16_TOP1 = 0.9
# tests/test_kernels.py::test_gmm_matches_oracle (G, rows per group, K, N, block_m),
# then test_gmm_uneven_groups as group sizes
GMM_CASES = [(4, 256, 256, 128, 128), (8, 128, 512, 256, 128), (2, 128, 128, 128, 64)]
UNEVEN = ([256, 128, 384], 256, 128, 128)


def _cfgs(dtype="float32", **kw):
    """(JAX, port) smoke configs at 4 layers (4 repeats of the one-layer unit)."""
    kw = {"n_layers": N_LAYERS, "dtype": dtype, "param_dtype": dtype, "remat": "none", **kw}
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


def _with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


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
    for name in (ARCH, "granite-moe-3b-a800m"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    cfg = get_config(ARCH)
    assert cfg.pattern_unit() == (("attn", True),) and cfg.num_pattern_repeats == 32


def test_full_config_parameter_count():
    """~3.30 B parameters (6.6 GB in bf16): 32 layers of 40 experts x 3 x
    1536 x 512 and attention, and the tied 49155 x 1536 embedding."""
    shapes = _flat(abstract_params(get_config(ARCH)))
    n = sum(int(np.prod(t.shape)) for t in shapes.values())
    assert 3.29e9 < n < 3.31e9, n
    assert "/unembed" not in shapes
    assert shapes["/blocks/u0/moe/w_up"].shape == (32, 40, 1536, 512)
    assert shapes["/blocks/u0/moe/w_down"].shape == (32, 40, 512, 1536)


# ------------------------------- gmm ---------------------------------------


def _gmm_inputs(sizes, K, N, seed):
    rng = np.random.default_rng(seed)
    M = int(sum(sizes))
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((len(sizes), K, N)).astype(np.float32))


def _gmm_jax(lhs, rhs, sizes, bm):
    """JAX's Pallas kernel (interpret mode) and its oracle on the same arrays."""
    sizes = np.asarray(sizes, np.int32)
    gids = jnp.asarray(np.repeat(np.arange(len(sizes)), sizes // bm), jnp.int32)
    kernel = jax_gmm(lhs, rhs, gids, block_m=bm, interpret=True)
    return np.asarray(kernel, np.float32), np.asarray(jax_gmm_ref(lhs, rhs, jnp.asarray(sizes)),
                                                      np.float32)


@pytest.mark.parametrize("case", [*GMM_CASES, UNEVEN],
                         ids=[f"case{i}" for i in range(len(GMM_CASES))] + ["uneven"])
def test_gmm_ref_matches_jax(case):
    if isinstance(case[0], list):
        sizes, K, N, bm = case
    else:
        G, rows, K, N, bm = case
        sizes = [rows] * G
    lhs, rhs = _gmm_inputs(sizes, K, N, seed=len(sizes))
    out = gmm_ref(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.tensor(sizes, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == (sum(sizes), N)
    kernel, oracle = _gmm_jax(jnp.asarray(lhs), jnp.asarray(rhs), sizes, bm)
    np.testing.assert_allclose(out.numpy(), kernel, atol=GMM_TOL, rtol=GMM_TOL)
    np.testing.assert_allclose(out.numpy(), oracle, atol=GMM_TOL, rtol=GMM_TOL)


def test_gmm_ref_bf16_matches_jax():
    sizes, K, N, bm = UNEVEN
    lhs, rhs = _gmm_inputs(sizes, K, N, seed=7)
    (jl, tl), (jr, tr) = _pair(lhs, "bfloat16"), _pair(rhs, "bfloat16")
    out = gmm_ref(tl, tr, sizes)
    assert out.dtype == torch.bfloat16
    kernel, oracle = _gmm_jax(jl, jr, sizes, bm)
    np.testing.assert_allclose(_f32(out), kernel, atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(_f32(out), oracle, atol=BF16_TOL, rtol=BF16_TOL)


def test_gmm_ref_fp32_output_of_bf16_inputs():
    """``out_dtype=float32``: the fp32 sums of the bf16 products, unrounded
    (the JAX oracle on the same values upcast, which is exact)."""
    sizes, K, N, _ = UNEVEN
    lhs, rhs = _gmm_inputs(sizes, K, N, seed=8)
    (jl, tl), (jr, tr) = _pair(lhs, "bfloat16"), _pair(rhs, "bfloat16")
    out = gmm_ref(tl, tr, sizes, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    want = np.asarray(jax_gmm_ref(jl.astype(jnp.float32), jr.astype(jnp.float32),
                                  jnp.asarray(sizes, jnp.int32)))
    np.testing.assert_allclose(out.numpy(), want, atol=GMM_TOL, rtol=GMM_TOL)
    # and rounding it once gives the bf16 output
    assert torch.equal(out.to(torch.bfloat16), gmm_ref(tl, tr, sizes))


def test_gmm_ref_takes_empty_groups_and_rejects_bad_sizes():
    lhs, rhs = torch.randn(6, 8), torch.randn(3, 8, 5)
    out = gmm_ref(lhs, rhs, [2, 0, 4])
    torch.testing.assert_close(out[:2], lhs[:2] @ rhs[0])
    torch.testing.assert_close(out[2:], lhs[2:] @ rhs[2])
    with pytest.raises(ValueError, match="sum of M"):
        gmm_ref(lhs, rhs, [2, 2, 1])
    with pytest.raises(ValueError, match="sum of M"):
        gmm_ref(lhs, rhs, [6, 0])


def test_ops_gmm_auto_on_cpu_takes_the_plain_version():
    import repro_torch.kernels.gmm as gk

    lhs, rhs = (torch.from_numpy(a) for a in _gmm_inputs([128, 128], 64, 32, seed=9))
    ids = torch.arange(2, dtype=torch.int32)
    before = gk.LAUNCHES
    out = ops.gmm(lhs, rhs, ids, [128, 128], impl="auto")
    assert gk.LAUNCHES == before
    assert torch.equal(out, ops.gmm(lhs, rhs, ids, [128, 128], impl="ref"))
    assert torch.equal(out, gmm_ref(lhs, rhs, [128, 128]))


def test_ops_gmm_refuses_what_it_cannot_route():
    lhs, rhs = torch.randn(8, 16), torch.randn(2, 16, 8)
    ids = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs group_sizes"):
        ops.gmm(lhs, rhs, ids, impl="ref")
    with pytest.raises(ValueError, match="needs group_sizes"):
        ops.gmm(lhs, rhs, ids, impl="auto")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ops.gmm(lhs, rhs, ids, [4, 4], impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.gmm(lhs, rhs, ids, [4, 4], impl="interpret")


# --------------------------------- MoE -------------------------------------


def _moe_case(dtype="float32", seed=3, **moe_kw):
    jcfg, cfg = _cfgs(dtype)
    if moe_kw:
        jcfg, cfg = _with_moe(jcfg, **moe_kw), _with_moe(cfg, **moe_kw)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg, getattr(jnp, dtype))
    return jcfg, cfg, jp, _torch_tree(jp)


def _capacity(cfg, T):
    return int(np.ceil(T * cfg.moe.top_k / cfg.moe.num_experts * cfg.moe.capacity_factor))


def _max_group(cfg, p, x):
    """The largest number of token copies routed to one expert."""
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model) @ p["router"], -1)
    top_e = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    return int(torch.bincount(top_e.reshape(-1), minlength=cfg.moe.num_experts).max())


# (name, dtype, tokens (batch, seq), MoE overrides): granite's SMOKE; a narrow
# case with granite's 40 experts and top-8 at capacity factor 1.0, which drops
# copies; one decode step of batch 4 at granite's capacity factor, C = 1
MOE_CASES = [
    ("smoke", "float32", (B, S), {}),
    ("smoke", "bfloat16", (B, S), {}),
    ("e40_k8_drops", "float32", (B, S), {"num_experts": 40, "top_k": 8, "capacity_factor": 1.0}),
    ("e40_k8_drops", "bfloat16", (B, S), {"num_experts": 40, "top_k": 8, "capacity_factor": 1.0}),
    ("decode_c1", "float32", (4, 1), {"num_experts": 40, "top_k": 8}),
    ("decode_c1", "bfloat16", (4, 1), {"num_experts": 40, "top_k": 8}),
]


@pytest.mark.parametrize("name, dtype, tokens, moe_kw", MOE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in MOE_CASES])
def test_moe_apply_matches_jax(name, dtype, tokens, moe_kw):
    jcfg, cfg, jp, p = _moe_case(dtype, seed=len(name), **moe_kw)
    x = np.random.default_rng(len(name)).standard_normal((*tokens, cfg.d_model)).astype(np.float32)
    capacity = _capacity(cfg, tokens[0] * tokens[1])
    if name == "e40_k8_drops":  # the case exists to drop copies: make sure it does
        assert _max_group(cfg, {k: v.float() for k, v in p.items()}, x) > capacity
    if name == "decode_c1":
        assert capacity == 1
    jx, tx = _pair(x, dtype)
    out, aux = moe.moe_apply(p, cfg, tx, impl="auto")
    jout, jaux = jax_moe.moe_apply(jp, jcfg, jx)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(out), np.asarray(jout, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LAYER_TOL)


def test_moe_expert_products_go_through_ops_gmm(monkeypatch):
    """Three products a MoE layer (up, gate, down), each over the (E*C, d)
    buffer with one row block of C rows per expert; up and gate in fp32."""
    _, cfg, _, p = _moe_case("bfloat16", seed=5)
    calls = []
    real = ops.gmm

    def spy(lhs, rhs, group_ids, group_sizes=None, *, impl="auto", out_dtype=None):
        calls.append((tuple(lhs.shape), tuple(rhs.shape), group_ids.tolist(), list(group_sizes),
                      impl, out_dtype))
        return real(lhs, rhs, group_ids, group_sizes, impl=impl, out_dtype=out_dtype)

    monkeypatch.setattr(ops, "gmm", spy)
    x = torch.randn(B, S, cfg.d_model).to(torch.bfloat16)
    moe.moe_apply(p, cfg, x, impl="ref")
    E, C, d, f = cfg.moe.num_experts, _capacity(cfg, B * S), cfg.d_model, cfg.moe.d_ff_expert
    ids, sizes = list(range(E)), [C] * E
    assert calls == [
        ((E * C, d), (E, d, f), ids, sizes, "ref", torch.float32),
        ((E * C, d), (E, d, f), ids, sizes, "ref", torch.float32),
        ((E * C, f), (E, f, d), ids, sizes, "ref", None),
    ]


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
    for path, want in jflat.items():
        np.testing.assert_allclose(flat[path].numpy(), want, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=path)


def test_decode_matches_forward(fp32):
    """Prefill-by-decode reproduces the full-sequence logits, with capacity to spare."""
    cfg = _with_moe(fp32["cfg"], capacity_factor=8.0)
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
    assert params["blocks"]["u0"]["moe"]["w_up"].dtype == torch.bfloat16
    logits, aux = forward(cfg, params, {"tokens": tokens}, device="cpu")
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert np.mean(logits.numpy().argmax(-1) == jlogits.argmax(-1)) >= BF16_TOP1


def test_params_from_jax_covers_every_key_path(fp32):
    jflat = _flat(_numpy_tree(fp32["jparams"]))
    flat = _flat(fp32["params"])
    assert set(flat) == set(jflat)
    assert "/embed" in flat and "/unembed" not in flat  # tied
    assert {p for p in flat if "/moe/" in p} == {
        f"/blocks/u0/moe/{k}" for k in ("router", "w_up", "w_gate", "w_down")}
    for path, want in jflat.items():
        assert flat[path].shape == want.shape and flat[path].dtype == torch.float32, path
        assert torch.equal(flat[path], tensor_from_numpy(want)), path
    own = _flat(init_params(fp32["cfg"], seed=0, device="cpu"))
    assert {p: (tuple(t.shape), t.dtype) for p, t in own.items()} == {
        p: (a.shape, torch.float32) for p, a in jflat.items()
    }


# -------------------------------- serve -------------------------------------


def test_serve_granite_smoke_on_cpu():
    tps = serve("granite-moe-3b-a800m", smoke=True, steps=4, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0
