"""The port's train step (``make_train_step``) against the JAX package's, on the CPU.

Both sides start from the reference's state after one step of its own (its
parameters and a non-zero ``OptState``, converted with ``params_from_jax``
and ``opt_state_from_jax``) and take one more step on the same numpy-made
batch, at ``impl="ref"``, with the trainer's schedule (linear warm-up, then
cosine). Accumulation over 2 microbatches is checked with the gradients kept
in fp32 and in bf16.

Tolerances (fp32 models):
* loss and ``grad_norm``: 1e-5 relative;
* parameters: every leaf within 1e-5 of its own largest magnitude;
* ``m`` and ``v``: every leaf within 1e-4 of its own largest magnitude (they
  carry the gradients, held at 1e-4 in tests/test_torch_train.py); with the
  gradients accumulated in bf16, within one bf16 ulp (2^-8) of it: both sides
  round fp32 sums that differ in their last bits, so an element near a bf16
  rounding boundary rounds the other way on one side (seen: one element of
  ``m`` 4e-4 of its leaf's largest off); the parameters then also within
  ``lr * 2^-8`` more, the update's move for such an element (seen: 1.08e-5 of
  the leaf's largest, 2.7e-6 against ``lr * 2^-8`` = 3.9e-6).
* ``step``: equal.
* the cases of the configs ported after the first four (``NEW_ARCHS``): an
  element whose gradient of this step the gradient bar cannot tell from 0
  (``|g| <= 1e-4 * max|g|`` of its leaf, g read from the reference's ``m``)
  is held within ``2 * LR`` instead (LR the schedule's peak), more than Adam's
  normalised step ``mhat / sqrt(vhat)`` (below 0.75 in size at the second
  step of a gradient that was 0 at the first) can move it apart: there a difference of fp32
  rounding in g is a large part of g, and Adam divides it out (seen:
  stablelm's embedding, one element with g 1.6e-8 in the reference and
  2.0e-8 in the port, 1e-6 of the leaf's largest g, moved 3.4e-5 apart
  against the 2.0e-5 bar). Every other element keeps the 1e-5 bar.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed.step import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import linear_warmup_cosine as jax_schedule
from repro_torch.configs import smoke_config
from repro_torch.distributed import make_prefill_step, make_train_step, train_state
from repro_torch.distributed.step import from_train_state
from repro_torch.models import abstract_params, forward, init_params
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamW, AdamWConfig, OptState, linear_warmup_cosine
from repro_torch.tree import flatten_with_paths, leaves, path_key, unflatten

B, S = 4, 32
LR, WARMUP, TOTAL = 1e-3, 1, 4
RTOL = 1e-5
PARAM_TOL = 1e-5
STATE_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8}
# granite: attention, an MoE with its aux loss, the tied embedding, and the
# shortest compile of the first four archs (their gradients are held in
# tests/test_torch_train.py, and their steps on the card in chip_smoke.py);
# then one step of each config ported since: whisper's encoder and
# cross-attention, phi-3-vision's image positions, gemma3-12b, mixtral,
# stablelm, nemotron
CASES = [("granite_moe_3b_a800m", 1, "float32"), ("granite_moe_3b_a800m", 2, "float32"),
         ("granite_moe_3b_a800m", 2, "bfloat16"), ("whisper_base", 1, "float32"),
         ("phi3_vision_4_2b", 1, "float32"), ("gemma3_12b", 1, "float32"),
         ("mixtral_8x7b", 1, "float32"), ("stablelm_3b", 1, "float32"),
         ("nemotron_4_340b", 1, "float32")]
NEW_ARCHS = ("whisper_base", "phi3_vision_4_2b", "gemma3_12b", "mixtral_8x7b", "stablelm_3b",
             "nemotron_4_340b")
GRAD_TOL = 1e-4  # the gradient bar of tests/test_torch_train.py


def _cfgs(arch):
    kw = {"dtype": "float32", "param_dtype": "float32", "remat": "block"}
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


def _batch(cfg, seed):
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


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what, extra=0.0):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.float().numpy() - want)))
    assert err <= tol * scale + extra, (what, err, scale)


def _close_where_conditioned(got, want, g, tol, lr, what):
    """``_close``'s bar on the elements whose gradient ``g`` stands above the
    gradient bar's resolution; within ``2 * lr`` on the others."""
    want, g = np.asarray(want, np.float32), np.asarray(g, np.float32)
    assert tuple(got.shape) == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-30)
    diff = np.abs(got.float().numpy() - want)
    noise = np.abs(g) <= GRAD_TOL * float(np.max(np.abs(g)))
    err = float(np.max(np.where(noise, 0.0, diff)))
    assert err <= tol * scale, (what, err, scale)
    err_noise = float(np.max(np.where(noise, diff, 0.0)))
    assert err_noise <= 2 * lr, (what, "gradient within the bar of 0", err_noise, 2 * lr)


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-accum{n}-{d}" for a, n, d in CASES])
def case(request):
    """The reference's state after one step, and its second step from there."""
    arch, accum, acc_dtype = request.param
    jcfg, cfg = _cfgs(arch)
    opt = JaxAdamW(JaxAdamWConfig(lr=jax_schedule(LR, WARMUP, TOTAL)))
    step = jax.jit(jax_make_train_step(jcfg, opt, accum_steps=accum, impl="ref",
                                       grad_accum_dtype=acc_dtype))
    jparams = jax_init_params(jcfg, seed=0)
    b1, b2 = _batch(cfg, 1), _batch(cfg, 2)
    p1, s1, _ = step(jparams, opt.init(jparams), b1)
    p2, s2, metrics = step(p1, s1, b2)
    return {"arch": arch, "cfg": cfg, "accum": accum, "acc_dtype": acc_dtype, "batch": b2,
            "p1": _numpy(p1), "s1": _numpy(s1), "p2": _numpy(p2), "s2": _numpy(s2),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def test_one_step_from_the_references_state_matches_it(case):
    cfg = case["cfg"]
    params = params_from_jax(cfg, case["p1"], device="cpu")
    state = opt_state_from_jax(cfg, case["s1"], device="cpu")
    assert int(state.step) == 1 and any(float(m.abs().max()) > 0 for m in state.m)
    opt = AdamW(AdamWConfig(lr=linear_warmup_cosine(LR, WARMUP, TOTAL)))
    step = make_train_step(cfg, opt, accum_steps=case["accum"], impl="ref",
                           grad_accum_dtype=case["acc_dtype"])
    new_params, new_state, metrics = step(params, state, case["batch"])

    want = case["metrics"]
    for k in ("loss", "grad_norm"):
        got = float(metrics[k])
        assert abs(got - want[k]) <= RTOL * abs(want[k]), (k, got, want[k])
    assert int(metrics["step"]) == want["step"] == 2 and new_state.step.dtype == torch.int32
    paths = [path_key(p) for p, _ in flatten_with_paths(new_params)]
    want_p = jax.tree_util.tree_leaves(case["p2"])
    want_m = jax.tree_util.tree_leaves(case["s2"].m)
    want_v = jax.tree_util.tree_leaves(case["s2"].v)
    bf16_acc = case["acc_dtype"] == "bfloat16"
    beta1 = JaxAdamWConfig().b1
    for i, path in enumerate(paths):
        if case["arch"] in NEW_ARCHS:
            m1 = np.asarray(jax.tree_util.tree_leaves(case["s1"].m)[i], np.float32)
            g = (np.asarray(want_m[i], np.float32) - beta1 * m1) / (1 - beta1)
            _close_where_conditioned(leaves(new_params)[i], want_p[i], g, PARAM_TOL, LR,
                                     f"params/{path}")
        else:
            _close(leaves(new_params)[i], want_p[i], PARAM_TOL, f"params/{path}",
                   extra=LR * 2.0**-8 if bf16_acc else 0.0)
        tol = STATE_TOL[case["acc_dtype"]]
        _close(new_state.m[i], want_m[i], tol, f"m/{path}")
        _close(new_state.v[i], want_v[i], tol, f"v/{path}")
    # the update is pure: what went in is unchanged
    for got, was in zip(leaves(params), jax.tree_util.tree_leaves(case["p1"]), strict=True):
        assert np.array_equal(got.numpy(), np.asarray(was))


def test_opt_state_from_jax_checks_paths_shapes_and_dtypes():
    jcfg, cfg = _cfgs("granite_moe_3b_a800m")
    jparams = jax_init_params(jcfg, seed=0)
    state = _numpy(JaxAdamW(JaxAdamWConfig()).init(jparams))
    got = opt_state_from_jax(cfg, state, device="cpu")
    assert isinstance(got, OptState) and len(got.m) == len(leaves(jparams))
    assert got.step.shape == () and got.step.dtype == torch.int32
    missing = {**state.m}
    missing.pop("final_norm")
    with pytest.raises(KeyError):
        opt_state_from_jax(cfg, state._replace(m=missing), device="cpu")
    wrong = jax.tree_util.tree_map(lambda a: a.astype(np.float16), state.v)
    with pytest.raises(ValueError):
        opt_state_from_jax(cfg, state._replace(v=wrong), device="cpu")
    with pytest.raises(ValueError):
        opt_state_from_jax(cfg, state._replace(step=np.zeros((1,), np.int32)), device="cpu")


def test_tree_walks_leaves_in_jaxs_order_and_rebuilds():
    tree = {"b": [np.ones(2), (np.zeros(1), 2)], "a": {"y": 1.0, "x": np.arange(3)},
            "opt": OptState(m=[np.ones(1)], v=[np.zeros(1)], step=np.int32(3))}
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = flatten_with_paths(tree)
    assert [path_key(p) for p, _ in got] == [
        "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in p)
        for p, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want, strict=True))
    back = unflatten(tree, leaves(tree))
    assert back.keys() == tree.keys() and isinstance(back["b"][1], tuple)
    assert back["b"][1][1] == 2 and isinstance(back["opt"], OptState)
    with pytest.raises(ValueError):
        unflatten(tree, leaves(tree)[:-1])
    with pytest.raises(ValueError):
        unflatten(tree, leaves(tree) + [1])


def test_train_state_names_moments_by_the_parameters_paths():
    _, cfg = _cfgs("granite_moe_3b_a800m")
    params = abstract_params(cfg)
    state = OptState(m=[torch.empty(p.shape, device="meta") for p in leaves(params)],
                     v=[torch.empty(p.shape, device="meta") for p in leaves(params)],
                     step=torch.zeros((), dtype=torch.int32))
    tree = train_state(params, state)
    keys = [path_key(p) for p, _ in flatten_with_paths(tree)]
    assert "opt/m/blocks/u0/attn/wq" in keys and "opt/step" in keys
    assert "params/blocks/u0/moe/w_up" in keys
    p2, s2 = from_train_state(tree)
    assert p2 is params and all(a is b for a, b in zip(s2.m, state.m, strict=True))


def test_prefill_step_gives_the_last_positions_logits():
    _, cfg = _cfgs("granite_moe_3b_a800m")
    params = init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 0)
    with torch.no_grad():
        got = make_prefill_step(cfg)(params, batch)
        logits, _ = forward(cfg, params, batch, device="cpu")
    assert torch.equal(got, logits[:, -1, :])


def test_train_step_refuses_the_forward_only_kernels():
    """``impl="cuda"`` (or ``"auto"`` on the card) would launch kernels that
    autograd cannot differentiate; the step says so instead of failing later."""
    _, cfg = _cfgs("granite_moe_3b_a800m")
    params = init_params(cfg, seed=0, device="cpu")
    opt = AdamW(AdamWConfig())
    step = make_train_step(cfg, opt, impl="cuda")
    with pytest.raises(ValueError, match="forward-only"):
        step(params, opt.init(leaves(params)), _batch(cfg, 0))

