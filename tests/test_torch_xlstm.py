"""The port's xlstm path (mLSTM and sLSTM blocks, the mLSTM plain versions) against the JAX package's, on the CPU.

Both sides run the same parameters (the JAX package's, converted with
``params_from_jax``) and the same numpy-made inputs. The JAX side reaches its
Pallas mLSTM kernel in interpret mode, as its own tests do; the port's side
runs the plain versions, which its dispatch picks for CPU tensors.

Tolerances:
* The mLSTM plain versions, fp32: ``max |a - b| / S <= 1e-4``, where ``S``
  is the size of the sums that make each output, ``(sum_s w'_ts |v_s| +
  |h_t| sum_s w'_ts) / den_t`` with ``w'_ts = e^{D_ts - m_t} |q_t|.|k_s| /
  sqrt(D)``, evaluated in fp64: rounding in any order moves an output by a
  few ulps of ``S``. The relative form of tests/test_kernels.py,
  ``max |a - b| / (|b| + 1e-2)``, cannot be held near 1e-5 on these inputs:
  where a row's denominator nearly cancels, every fp32 evaluation, the JAX
  package's own included, lies 3e-4 to 1e-3 from an fp64 one in that form.
  Measured in ``S``: <= 1.1e-6 against the JAX versions, and up to 2.5e-5 in
  processes where torch's CPU ``exp`` returned results 1.5e-4 off (seen on
  the first mLSTM call of some processes with JAX loaded, not reproduced
  alone), hence 1e-4.
* fp32 blocks and the fp32 model: 1e-5 per block and 1e-4 for logits after
  16 layers; both sides compute in fp32 and differ only in summation order.
* bf16 whole models are held to top-1 agreement >= 0.9, as the other slices
  are: bf16 ulps from sums taken in another order reach the next layers.
* decode against forward: the bar of tests/test_models.py::test_decode_matches_forward (2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.mlstm import mlstm_chunkwise as jax_mlstm_chunkwise
from repro.kernels.ref import mlstm_chunked_scan as jax_mlstm_chunked_scan
from repro.kernels.ref import mlstm_chunkwise_ref as jax_mlstm_chunkwise_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, mlstm_chunked_scan, mlstm_chunkwise_ref
from repro_torch.launch.serve import serve
from repro_torch.models import abstract_params, decode_step, forward, init_cache, init_params, xlstm
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

ARCH = "xlstm_350m"
B, S = 2, 64
LAYER_TOL = 1e-5
FWD_TOL = 1e-4
DECODE_VS_FORWARD_TOL = 2e-2
BF16_TOP1 = 0.9
# tests/test_kernels.py: MLSTM_CASES (B, T, H, D, L)
MLSTM_CASES = [(2, 128, 2, 64, 64), (1, 256, 4, 64, 128), (1, 128, 1, 128, 32)]
MLSTM_TOL = 1e-4  # in units of the sums' size S (module docstring)


def _cfgs(dtype="float32", **kw):
    """(JAX, port) smoke configs at 16 layers: two repeats of the 8-layer unit."""
    kw = {"n_layers": 16, "dtype": dtype, "param_dtype": dtype, "remat": "none", **kw}
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


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


def _fp64(q, k, v, i_gate, f_gate):
    """The mLSTM (the quadratic form) and S (module docstring) of every output
    (B, T, H, D), both in fp64."""
    q, k, v, i_gate, f_gate = (np.asarray(a, np.float64) for a in (q, k, v, i_gate, f_gate))
    T, D = q.shape[1], q.shape[3]
    F = np.cumsum(-np.logaddexp(0.0, -f_gate), axis=1)  # (B, T, H)
    Dm = (F[:, :, None, :] - F[:, None, :, :] + i_gate[:, None, :, :]).transpose(0, 3, 1, 2)
    Dm = np.where(np.tril(np.ones((T, T), bool)), Dm, -np.inf)  # (B, H, T, S)
    m = Dm.max(-1, keepdims=True)
    decay = np.exp(Dm - m)
    w = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(D) * decay
    w_abs = np.einsum("bthd,bshd->bhts", np.abs(q), np.abs(k)) / np.sqrt(D) * decay
    den = np.maximum(np.abs(w.sum(-1)), np.exp(-m[..., 0])).transpose(0, 2, 1)[..., None]
    h = np.einsum("bhts,bshd->bthd", w, v) / den
    return h, (np.einsum("bhts,bshd->bthd", w_abs, np.abs(v))
               + np.abs(h) * w_abs.sum(-1).transpose(0, 2, 1)[..., None]) / den


def _sum_size(*arrays):
    return _fp64(*arrays)[1]


def _in_sum_units(a, b, size):
    """max |a - b| / S."""
    return float(np.max(np.abs(_f32(a) - _f32(b)) / size))


def _mlstm_inputs(B_, T, H, D, seed=0):
    """The inputs of tests/test_kernels.py: i ~ N(0, 1), f ~ N(2, 2)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B_, T, H, D)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((B_, T, H)).astype(np.float32)
    fg = (rng.standard_normal((B_, T, H)) * 2.0 + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _jax_args(arrays, dtype="float32"):
    return [jnp.asarray(a, getattr(jnp, dtype)) if a.ndim == 4 else jnp.asarray(a) for a in arrays]


def _port_args(arrays, dtype="float32"):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) if a.ndim == 4 else torch.from_numpy(a)
            for a in arrays]


@pytest.fixture(scope="module")
def fp32():
    """Configs, converted params, tokens and the JAX forward (Pallas interpret) outputs."""
    jcfg, cfg = _cfgs("float32")
    jparams = jax_init_params(jcfg, seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, impl="interpret"))(
        jparams, jnp.asarray(tokens)
    )
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "params": params, "tokens": tokens,
            "jlogits": np.asarray(jlogits)}


# ------------------------------- configs -----------------------------------


def test_configs_match_reference():
    for name in ("xlstm_350m", "xlstm-350m"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    cfg = get_config(ARCH)
    unit = cfg.pattern_unit()
    assert len(unit) == 8 and cfg.num_pattern_repeats == 3
    assert [k for k, _ in unit] == ["mlstm"] * 7 + ["slstm"]


def test_full_config_parameter_count():
    """~524 M parameters: 21 mLSTM blocks of 18.9 M, 3 sLSTM of 8.0 M, and
    the untied 50304 x 1024 embedding and unembedding."""
    cfg = get_config(ARCH)
    shapes = _flat(abstract_params(cfg))
    n = sum(int(np.prod(t.shape)) for t in shapes.values())
    assert 523e6 < n < 525e6, n
    per_unit = {u: sum(int(np.prod(t.shape[1:])) for p, t in shapes.items() if p.startswith(f"/blocks/{u}/"))
                for u in ("u0", "u7")}
    assert 18.8e6 < per_unit["u0"] < 19.0e6 and 7.9e6 < per_unit["u7"] < 8.1e6, per_unit


# --------------------------- mLSTM plain versions ---------------------------


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[f"case{i}" for i in range(len(MLSTM_CASES))])
def test_mlstm_chunkwise_ref_matches_jax(case):
    B_, T, H, D, _ = case
    arrays = _mlstm_inputs(B_, T, H, D)
    out = mlstm_chunkwise_ref(*_port_args(arrays))
    want = jax_mlstm_chunkwise_ref(*_jax_args(arrays))
    assert out.dtype == torch.float32 and out.shape == (B_, T, H, D)
    assert _in_sum_units(out, want, _sum_size(*arrays)) < MLSTM_TOL


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[f"case{i}" for i in range(len(MLSTM_CASES))])
def test_mlstm_chunked_scan_matches_jax_and_its_kernel(case):
    """The port's chunked scan against JAX's chunked scan and its Pallas kernel
    (interpret mode) at the kernel test's chunk length."""
    B_, T, H, D, L = case
    arrays = _mlstm_inputs(B_, T, H, D, seed=1)
    out = mlstm_chunked_scan(*_port_args(arrays), chunk=L)
    size = _sum_size(*arrays)
    assert _in_sum_units(out, jax_mlstm_chunked_scan(*_jax_args(arrays), chunk=L), size) < MLSTM_TOL
    want = jax_mlstm_chunkwise(*_jax_args(arrays), chunk=L, interpret=True)
    assert _in_sum_units(out, want, size) < MLSTM_TOL


@pytest.mark.parametrize("L", [32, 64, 128])
def test_mlstm_chunked_scan_chunk_sizes(L):
    """tests/test_kernels.py::test_mlstm_chunked_scan_matches_quadratic, on
    the port's side and against JAX's chunked scan."""
    arrays = _mlstm_inputs(1, 128, 2, 32, seed=2)
    size = _sum_size(*arrays)
    out = mlstm_chunked_scan(*_port_args(arrays), chunk=L)
    assert _in_sum_units(out, mlstm_chunkwise_ref(*_port_args(arrays)), size) < MLSTM_TOL
    assert _in_sum_units(out, jax_mlstm_chunked_scan(*_jax_args(arrays), chunk=L), size) < MLSTM_TOL


def test_mlstm_chunked_scan_in_fp64():
    """``dtype=float64`` runs the chunked scan in fp64 (the accuracy reference
    of chip_smoke.py): it meets an fp64 evaluation of the quadratic form."""
    arrays = _mlstm_inputs(1, 256, 2, 32, seed=5)
    exact, size = _fp64(*arrays)
    out = mlstm_chunked_scan(*[torch.from_numpy(a).double() for a in arrays], chunk=64,
                             dtype=torch.float64)
    assert out.dtype == torch.float64
    assert float(np.max(np.abs(out.numpy() - exact) / size)) < 1e-12
    fp32 = mlstm_chunked_scan(*_port_args(arrays), chunk=64)
    assert _in_sum_units(fp32, exact, size) < MLSTM_TOL


def test_mlstm_chunked_scan_bf16_matches_jax():
    """bf16 q, k, v: fp32 inside on both sides, then one rounding of the
    output, which may fall to either side: one bf16 ulp (2^-8 relative)."""
    arrays = _mlstm_inputs(1, 128, 2, 64, seed=3)
    out = mlstm_chunked_scan(*_port_args(arrays, "bfloat16"), chunk=64)
    want = _f32(jax_mlstm_chunked_scan(*_jax_args(arrays, "bfloat16"), chunk=64))
    assert out.dtype == torch.bfloat16
    bf16 = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) if a.ndim == 4 else a
            for a in arrays]
    bar = 2.0**-8 * np.abs(want) + MLSTM_TOL * _sum_size(*bf16)
    assert np.all(np.abs(_f32(out) - want) <= bar)


def test_mlstm_chunked_scan_rejects_ragged_T():
    arrays = _port_args(_mlstm_inputs(1, 100, 1, 16))
    with pytest.raises(ValueError, match="not a multiple of the chunk 64"):
        mlstm_chunked_scan(*arrays, chunk=64)


def test_ops_mlstm_auto_on_cpu_takes_the_plain_version():
    """``ops.mlstm``'s ``"ref"`` (and ``"auto"`` on the CPU) is the chunked scan
    at ``chunk=min(256, T)``, as the reference's ``"ref"`` is."""
    import repro_torch.kernels.mlstm as ml

    arrays = _port_args(_mlstm_inputs(1, 512, 2, 16, seed=4))
    before = ml.LAUNCHES
    out = ops.mlstm(*arrays, impl="auto")
    assert ml.LAUNCHES == before
    assert torch.equal(out, ops.mlstm(*arrays, impl="ref"))
    assert torch.equal(out, mlstm_chunked_scan(*arrays, chunk=256))


def test_ops_mlstm_cuda_on_cpu_raises():
    arrays = _port_args(_mlstm_inputs(1, 64, 1, 16))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ops.mlstm(*arrays, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.mlstm(*arrays, impl="interpret")


# ------------------------------ mLSTM block --------------------------------


@pytest.fixture(scope="module")
def mblock():
    jcfg, cfg = _cfgs("float32")
    jp = jax_xlstm.mlstm_block_init(jax.random.PRNGKey(6), jcfg, jnp.float32)
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(jp), x


def _layout_matches(own, ref, lead):
    flat, want = _flat(own), _flat(ref)
    assert set(flat) == set(want)
    for k, t in flat.items():
        assert t.shape == (*lead, *want[k].shape) and t.dtype == want[k].dtype, k


def test_mlstm_block_init_layout():
    """The reference's keys and shapes under the stacked-repeat axis; w_i and
    w_f are fp32 in a bf16 block."""
    jcfg, cfg = _cfgs("bfloat16")
    jp = _torch_tree(jax_xlstm.mlstm_block_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    own = xlstm.mlstm_block_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu",
                                 lead=(2,))
    _layout_matches(own, jp, (2,))
    assert own["w_i"].dtype == own["w_f"].dtype == torch.float32
    assert own["wq"].dtype == torch.bfloat16


def test_mlstm_block_apply_matches_jax(mblock):
    jcfg, cfg, jp, p, x = mblock
    out = xlstm.mlstm_block_apply(p, cfg, torch.from_numpy(x))
    want = jax_xlstm.mlstm_block_apply(jp, jcfg, jnp.asarray(x), impl="interpret")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=LAYER_TOL, rtol=LAYER_TOL)


def _random_state(jstate, seed):
    """A non-zero decode state in the reference's layout (m finite, n away from 0)."""
    rng = np.random.default_rng(seed)
    st = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.asarray(v).dtype)
          for k, v in jstate.items()}
    if "C" in st:
        st["m"] = rng.standard_normal(st["m"].shape).astype(np.float32)
        st["n"] = st["n"] + 1.0
    else:
        st["n"] = np.abs(st["n"]) + 1.0
    return st


def _check_decode(port_fn, jax_fn, p, jp, cfg, jcfg, x, jstate, seed):
    st = _random_state(jstate, seed)
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    out, state = port_fn(p, cfg, torch.from_numpy(x[:, :1]), state)
    jout, jst = jax_fn(jp, jcfg, jnp.asarray(x[:, :1]), {k: jnp.asarray(v) for k, v in st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=LAYER_TOL, rtol=LAYER_TOL)
    assert set(state) == set(jst)
    for k in jst:
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jst[k]), atol=LAYER_TOL,
                                   rtol=LAYER_TOL, err_msg=k)


def test_mlstm_block_decode_matches_jax(mblock):
    """One step from a non-zero state: output, C, n, m and conv window."""
    jcfg, cfg, jp, p, x = mblock
    _check_decode(xlstm.mlstm_block_decode, jax_xlstm.mlstm_block_decode, p, jp, cfg, jcfg, x,
                  jax_xlstm.mlstm_state_init(jcfg, B), seed=7)


def test_mlstm_state_init_layout():
    jcfg, cfg = _cfgs("bfloat16")
    st = xlstm.mlstm_state_init(cfg, 3, torch.bfloat16, "cpu", lead=(2,))
    jst = jax_xlstm.mlstm_state_init(jcfg, 3, jnp.bfloat16)
    assert set(st) == set(jst) == {"C", "n", "m", "conv"}
    for k in jst:
        assert st[k].shape == (2, *jst[k].shape), k
        np.testing.assert_array_equal(_f32(st[k][1]), np.asarray(jst[k], np.float32), err_msg=k)
    assert NEG_INF == -1e30 and bool((st["m"] == np.float32(-1e30)).all())
    assert st["conv"].dtype == torch.bfloat16
    assert all(st[k].dtype == torch.float32 for k in ("C", "n", "m"))


# ------------------------------ sLSTM block --------------------------------


@pytest.fixture(scope="module")
def sblock():
    jcfg, cfg = _cfgs("float32")
    jp = jax_xlstm.slstm_block_init(jax.random.PRNGKey(8), jcfg, jnp.float32)
    x = np.random.default_rng(8).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(jp), x


def test_slstm_block_init_layout():
    jcfg, cfg = _cfgs("bfloat16")
    jp = _torch_tree(jax_xlstm.slstm_block_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    own = xlstm.slstm_block_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu",
                                 lead=(3,))
    _layout_matches(own, jp, (3,))
    d = cfg.d_model
    assert own["w_ffn_up"].shape == (3, d, int(d * 4 / 3))


def test_slstm_step_matches_jax(sblock):
    """The stacked recurrence (one product a step) against the reference's four."""
    jcfg, cfg, jp, p, _ = sblock
    rng = np.random.default_rng(9)
    d = cfg.d_model
    carry = [rng.standard_normal((B, d)).astype(np.float32) for _ in range(4)]
    carry[1] = np.abs(carry[1]) + 1.0
    gates = rng.standard_normal((B, 4 * d)).astype(np.float32)
    new = xlstm._slstm_step(xlstm._recurrent(p), tuple(torch.from_numpy(c) for c in carry),
                            torch.from_numpy(gates))
    jnew, _ = jax_xlstm._slstm_step(jp, jcfg, tuple(jnp.asarray(c) for c in carry),
                                    jnp.asarray(gates))
    for name, a, b in zip("cnmh", new, jnew, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LAYER_TOL, rtol=LAYER_TOL,
                                   err_msg=name)


def test_slstm_block_apply_matches_jax(sblock):
    jcfg, cfg, jp, p, x = sblock
    out = xlstm.slstm_block_apply(p, cfg, torch.from_numpy(x))
    want = jax_xlstm.slstm_block_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=LAYER_TOL, rtol=LAYER_TOL)


def test_slstm_block_decode_matches_jax(sblock):
    """One step from a non-zero state: output, c, n, m, h and conv window."""
    jcfg, cfg, jp, p, x = sblock
    _check_decode(xlstm.slstm_block_decode, jax_xlstm.slstm_block_decode, p, jp, cfg, jcfg, x,
                  jax_xlstm.slstm_state_init(jcfg, B), seed=10)


def test_slstm_state_init_layout():
    jcfg, cfg = _cfgs("bfloat16")
    st = xlstm.slstm_state_init(cfg, 3, torch.bfloat16, "cpu", lead=(2,))
    jst = jax_xlstm.slstm_state_init(jcfg, 3, jnp.bfloat16)
    assert set(st) == set(jst) == {"c", "n", "m", "h", "conv"}
    for k in jst:
        assert st[k].shape == (2, *jst[k].shape), k
        np.testing.assert_array_equal(_f32(st[k][0]), np.asarray(jst[k], np.float32), err_msg=k)
    assert bool((st["n"] == 1).all()) and bool((st["m"] == 0).all())
    assert st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32


# ------------------------------ whole model --------------------------------


def test_forward_matches_jax(fp32):
    logits, aux = forward(fp32["cfg"], fp32["params"], {"tokens": fp32["tokens"]}, device="cpu")
    assert logits.dtype == torch.float32 and logits.shape == (B, S, fp32["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), fp32["jlogits"], atol=FWD_TOL, rtol=FWD_TOL)
    assert float(aux) == 0.0  # no MoE


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
    assert {p.rsplit("/", 1)[1] for p in flat} == {"C", "n", "m", "conv", "c", "h"}
    for path, want in jflat.items():
        assert flat[path].shape == want.shape, path
        np.testing.assert_allclose(flat[path].numpy(), want, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=path)


def test_decode_matches_forward(fp32):
    """Prefill-by-decode reproduces the full-sequence logits."""
    cfg, params, n = fp32["cfg"], fp32["params"], 16
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
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    logits, _ = forward(cfg, params, {"tokens": tokens}, device="cpu")
    assert bool(torch.isfinite(logits).all())
    assert np.mean(logits.numpy().argmax(-1) == np.asarray(jlogits).argmax(-1)) >= BF16_TOP1


def test_params_from_jax_covers_every_key_path(fp32):
    jflat = _flat(_numpy_tree(fp32["jparams"]))
    flat = _flat(fp32["params"])
    assert set(flat) == set(jflat)
    assert {p.split("/")[3] for p in flat if p.startswith("/blocks/")} == {"block"}
    for path, want in jflat.items():
        assert flat[path].shape == want.shape and flat[path].dtype == torch.float32, path
        assert torch.equal(flat[path], tensor_from_numpy(want)), path
    own = _flat(init_params(fp32["cfg"], seed=0, device="cpu"))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: a.shape for p, a in jflat.items()}


def test_params_from_jax_keeps_fp32_gates_in_a_bf16_tree():
    jcfg, cfg = _cfgs("bfloat16")
    jflat = _flat(_numpy_tree(jax_init_params(jcfg, seed=3)))
    params = _flat(params_from_jax(cfg, jax.tree_util.tree_map(
        np.asarray, jax_init_params(jcfg, seed=3)), device="cpu"))
    gates = [p for p in params if p.endswith(("/block/w_i", "/block/w_f")) and "/u7/" not in p]
    assert len(gates) == 14
    for path, t in params.items():
        want = "float32" if path in gates else "bfloat16"
        assert str(jflat[path].dtype) == want and t.dtype == getattr(torch, want), path
    # the sLSTM block's w_i and w_f are ordinary bf16 projections
    assert params["/blocks/u7/block/w_i"].dtype == torch.bfloat16


# -------------------------------- serve -------------------------------------


def test_serve_xlstm_smoke_on_cpu():
    tps = serve("xlstm-350m", smoke=True, steps=4, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0
    tps = serve(ARCH, smoke=True, steps=3, n_layers=16, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0


@pytest.mark.parametrize("n_layers", [7, 12])
def test_serve_cuts_only_whole_units(n_layers):
    with pytest.raises(ValueError, match="whole pattern units of 8"):
        serve(ARCH, smoke=True, n_layers=n_layers, device="cpu")
