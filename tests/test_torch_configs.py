"""The port's remaining configs against the JAX package's, on the CPU.

whisper-base (the encoder and cross-attention), phi-3-vision-4.2b (the
vision stub), gemma3-12b, mixtral-8x7b, stablelm-3b and nemotron-4-340b
(LayerNorm, squared ReLU, GQA 96/8 at head dim 192 in full width, untied
embeddings), each at its smoke config; the registries of all ten configs;
the logits product on bf16 operands; the initialiser's chunked draws. Both
sides run the same parameters (the JAX package's ``init_params`` tree,
converted with ``params_from_jax``) on the same numpy-made batch; the
reference runs at ``impl="ref"``, compiled once per arch in a module
fixture. Their losses and gradients are held in
tests/test_torch_train.py and their train steps in
tests/test_torch_train_step.py.

Tolerances:
* fp32 logits (forward and each decode step): max |port - ref| <= 1e-5 *
  max |ref|; both sides sum the same fp32 terms in other orders.
* bf16 logits: top-1 agreement >= 0.99 over the batch's positions.
* decode against forward: the bar of tests/test_models.py::test_decode_matches_forward
  (2e-2), fp32, with MoE capacity to spare and no image positions, as there.
* module level (cross-attention, the encoder): 1e-5 fp32, 1e-2 bf16 (a bf16
  ulp and some: the same roundings at other places of the sums).
* the port's plain attention against the reference's Pallas kernel in
  interpret mode: 2e-5, the fp32 bar of tests/test_kernels.py.
* the logits product on bf16 operands against the reference's einsum
  (``preferred_element_type=float32``): 1e-6 * max; both sum exact fp32
  products, in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_transformer
from repro_torch.configs import ALIASES as PORT_ALIASES
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS
from repro_torch.configs import all_configs, get_config, smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_transformer
from repro_torch.models import (
    abstract_params,
    attention,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
)
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

ARCHS = ["whisper_base", "phi3_vision_4_2b", "gemma3_12b", "mixtral_8x7b", "stablelm_3b",
         "nemotron_4_340b"]
ALIASES = {"whisper_base": "whisper-base", "phi3_vision_4_2b": "phi-3-vision-4.2b",
           "gemma3_12b": "gemma3-12b", "mixtral_8x7b": "mixtral-8x7b", "stablelm_3b": "stablelm-3b",
           "nemotron_4_340b": "nemotron-4-340b"}
B, S = 2, 64
LOGIT_RTOL = 1e-5
TOP1_MIN = 0.99
DECODE_VS_FORWARD_TOL = 2e-2
LAYER_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ATTN_TOL = 2e-5
LOGITS_BF16_RTOL = 1e-6
DECODE_STEPS = 8


def _cfgs(arch, dtype="float32", **kw):
    kw = {"dtype": dtype, "param_dtype": dtype, "remat": "none", **kw}
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


def _batch(cfg, seed=0, S=S):
    """Text tokens, and the config's modality input: frame embeddings
    (whisper) or patch embeddings (phi-3-vision), fp32 numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["enc_frames"] = rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.vision_tokens:
        batch["img_embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


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


def _jax_enc_out(jcfg, jparams, batch):
    """The reference's encoder output, as its ``forward`` computes it."""
    frames = jnp.asarray(batch["enc_frames"]).astype(jcfg.dtype)
    return jax_transformer._run_encoder(jcfg, jparams, frames, "ref")


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.max(np.abs(got - want))), float(np.max(np.abs(want)))
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One arch in fp32: configs, params on both sides, a batch, the
    reference's logits and its decode steps' logits (with ``enc_out`` for
    whisper), from one compiled function each."""
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    jparams = jax_init_params(jcfg, seed=0)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jaux = jax.jit(lambda p, b: jax_forward(jcfg, p, b, impl="ref"))(jparams, jb)
    enc_out = _jax_enc_out(jcfg, jparams, batch) if cfg.encoder is not None else None

    @jax.jit
    def steps(p, e):
        cache = jax_init_cache(jcfg, B, 2 * DECODE_STEPS)
        out = []
        for i in range(DECODE_STEPS):
            lg, cache = jax_decode_step(jcfg, p, cache, jb["tokens"][:, i : i + 1],
                                        jnp.asarray(i, jnp.int32), enc_out=e, impl="ref")
            out.append(lg)
        return out, cache

    jsteps, jcache = steps(jparams, enc_out)
    return {"arch": arch, "jcfg": jcfg, "cfg": cfg, "jparams": jparams, "batch": batch,
            "params": params_from_jax(cfg, _numpy_tree(jparams), device="cpu"),
            "jlogits": np.asarray(jlogits), "jaux": float(jaux),
            "jsteps": [np.asarray(s) for s in jsteps], "jcache": _numpy_tree(jcache),
            "enc_out": None if enc_out is None else np.asarray(enc_out)}


# ------------------------------- configs -----------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_parameter_counts_match_the_reference(arch):
    for name in (arch, ALIASES[arch]):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    assert (get_config(arch).param_count(active_only=True)
            == jax_get_config(arch).param_count(active_only=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_tree_has_the_references_shapes(arch):
    """The port's full-width tree (meta tensors) against the reference's
    ``abstract_params``: every key path, shape and dtype, the encoder's and
    cross-attention's included."""
    tree = jax_transformer.abstract_params(jax_get_config(arch))
    want = _flat(jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)), tree,
                                        is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct)))
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in _flat(abstract_params(get_config(arch))).items()}
    assert got == want


def test_mixtral_cuts_to_whole_one_layer_units():
    cfg = get_config("mixtral_8x7b")
    assert cfg.pattern_unit() == (("attn", True),) and cfg.num_pattern_repeats == 32
    cut = dataclasses.replace(cfg, n_layers=16)
    assert cut.num_pattern_repeats == 16


def test_registries_equal_the_references():
    """The same ten ids in the reference's order, the same aliases, and every
    full and smoke config field for field."""
    assert PORT_ARCH_IDS == JAX_ARCH_IDS and len(PORT_ARCH_IDS) == 10
    assert PORT_ALIASES == JAX_ALIASES
    port, ref = all_configs(), jax_all_configs()
    assert list(port) == list(ref) == PORT_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in port.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.items()}
    for name in PORT_ARCH_IDS:
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(jax_smoke_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_nemotron_counts_and_cuts_to_whole_one_layer_units():
    """341,025,619,968 parameters (the reference's ``param_count``, all of them
    active), 3.454 B a layer; cut to 6 of its 96 one-layer units, the tree
    (the untied 256,000 x 18,432 embedding and unembedding with it) holds
    60.32 GB in bf16."""
    cfg = get_config("nemotron-4-340b")
    assert cfg.param_count() == cfg.param_count(active_only=True) == 341_025_619_968
    assert cfg.pattern_unit() == (("attn", False),) and cfg.num_pattern_repeats == 96
    assert not cfg.tie_embeddings and cfg.resolved_head_dim == 192
    cut = dataclasses.replace(cfg, n_layers=6)
    assert cut.num_pattern_repeats == 6
    per_layer = (cfg.param_count() - cut.param_count()) // 90
    assert per_layer == 3_454_046_208
    assert sum(t.numel() for t in _flat(abstract_params(cut)).values()) * 2 == 60_323_438_592


# ------------------------------- the logits product -------------------------


@pytest.mark.parametrize("tied, d, V", [(True, 1152, 2048), (False, 2304, 1024)],
                         ids=["tied_d1152", "untied_d2304"])
def test_bf16_logits_match_the_references_einsum(tied, d, V):
    """``_logits`` on bf16 operands (a tied and an untied unembedding) against
    the reference's ``einsum("bsd,vd->bsv", ..., preferred_element_type=float32)``
    on the same operands."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, 48, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) * 0.5).astype(np.float32)
    cfg = dataclasses.replace(smoke_config("nemotron_4_340b"), tie_embeddings=tied)
    xb, tb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(table, jnp.bfloat16)
    want = jax.jit(lambda x_, t_: jnp.einsum("bsd,vd->bsv", x_, t_,
                                             preferred_element_type=jnp.float32))(xb, tb)
    params = {"embed" if tied else "unembed": tensor_from_numpy(np.asarray(tb))}
    got = port_transformer._logits(cfg, params, tensor_from_numpy(np.asarray(xb)))
    assert got.dtype == torch.float32 and got.shape == (B, 48, V)
    _close(got.numpy(), np.asarray(want), LOGITS_BF16_RTOL, "logits")


def test_logits_on_the_cpu_and_while_autograd_records_upcast_both_operands():
    """The CPU route (and the card's while autograd records) is the fp32
    product of the upcast operands, bit for bit; the card's inference route
    is held against it in tests/test_torch_cuda.py and chip_smoke.py."""
    cfg = dataclasses.replace(smoke_config("nemotron_4_340b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(0)).bfloat16()
    want = torch.matmul(x.float(), params["unembed"].float().t())
    assert torch.equal(port_transformer._logits(cfg, params, x), want)
    got = port_transformer._logits(cfg, params, x.requires_grad_())
    assert got.requires_grad and torch.equal(got.detach(), want)


# ------------------------------- initialisation -----------------------------


def test_truncated_normal_draws_a_large_leaf_in_chunks(monkeypatch):
    """A leaf of at most ``DRAW_CHUNK`` numbers is one fp32 draw, scaled and
    cast; a larger one is the same draws made ``DRAW_CHUNK`` at a time from the
    one generator, written into the leaf in order."""
    def draw(gen, n):
        x = torch.empty(n, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return x.mul_(0.5).to(torch.bfloat16)

    small = port_layers.truncated_normal(torch.Generator().manual_seed(1), (6, 10), 0.5,
                                         torch.bfloat16, "cpu")
    assert small.dtype == torch.bfloat16 and torch.equal(
        small.view(-1), draw(torch.Generator().manual_seed(1), 60))
    monkeypatch.setattr(port_layers, "DRAW_CHUNK", 16)
    big = port_layers.truncated_normal(torch.Generator().manual_seed(1), (6, 10), 0.5,
                                       torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(1)
    want = torch.cat([draw(gen, n) for n in (16, 16, 16, 12)])
    assert torch.equal(big.view(-1), want)
    assert float(big.float().abs().max()) <= 1.0


# ------------------------------- the models --------------------------------


def test_params_from_jax_covers_every_key_path(ref):
    jflat = _flat(_numpy_tree(ref["jparams"]))
    flat = _flat(ref["params"])
    assert set(flat) == set(jflat)
    for path, want in jflat.items():
        assert torch.equal(flat[path], tensor_from_numpy(want)), path
    if ref["cfg"].encoder is not None:
        assert any(p.startswith("/encoder/layers/attn") for p in flat)
        assert any("/cross/" in p for p in flat) and any("/cross_norm/" in p for p in flat)
    own = _flat(init_params(ref["cfg"], seed=0, device="cpu"))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: a.shape for p, a in jflat.items()}


def test_fp32_forward_matches_the_reference(ref):
    logits, aux = forward(ref["cfg"], ref["params"], ref["batch"], impl="ref", device="cpu")
    assert logits.dtype == torch.float32 and logits.shape == (B, S, ref["cfg"].vocab_size)
    _close(logits.numpy(), ref["jlogits"], LOGIT_RTOL, "logits")
    assert abs(float(aux) - ref["jaux"]) <= 1e-5 * max(abs(ref["jaux"]), 1.0)


def test_fp32_decode_steps_match_the_references(ref):
    """``DECODE_STEPS`` steps from an empty cache, whisper's with ``enc_out``
    (the reference's encoder output, converted): logits each step and the
    caches after."""
    cfg, params = ref["cfg"], ref["params"]
    cache = init_cache(cfg, B, 2 * DECODE_STEPS, device="cpu")
    enc_out = None if ref["enc_out"] is None else tensor_from_numpy(ref["enc_out"])
    for i in range(DECODE_STEPS):
        lg, cache = decode_step(cfg, params, cache, ref["batch"]["tokens"][:, i : i + 1], i,
                                enc_out=enc_out, device="cpu")
        _close(lg.numpy(), ref["jsteps"][i], LOGIT_RTOL, f"step {i}")
    jflat, flat = _flat(ref["jcache"]), _flat(cache)
    assert set(flat) == set(jflat)
    for path, want in jflat.items():
        _close(flat[path].numpy(), want, LOGIT_RTOL, path)


def test_bf16_forward_top1_matches_the_reference(ref):
    jcfg, cfg = _cfgs(ref["arch"], "bfloat16")
    jparams = jax_init_params(jcfg, seed=2)
    batch = _batch(cfg, seed=2)
    jlogits = np.asarray(jax.jit(lambda p, b: jax_forward(jcfg, p, b, impl="ref")[0])(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    params = params_from_jax(cfg, _numpy_tree(jparams), device="cpu")
    logits, _ = forward(cfg, params, batch, device="cpu")
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    top1 = float(np.mean(logits.numpy().argmax(-1) == jlogits.argmax(-1)))
    assert top1 >= TOP1_MIN, top1


def test_fp32_decode_matches_forward(ref):
    """Prefill-by-decode reproduces the full-sequence logits
    (tests/test_models.py::test_decode_matches_forward), past gemma3-12b's and
    mixtral's 64-slot windows so their ring buffers wrap; whisper decodes with
    ``encode``'s output."""
    cfg, params = ref["cfg"], ref["params"]
    if cfg.vision_tokens:
        cfg = dataclasses.replace(cfg, vision_tokens=0)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    n = 80 if cfg.sliding_window else 16
    batch = _batch(cfg, seed=1, S=n)
    batch = {k: v[:1] for k, v in batch.items()}
    full, _ = forward(cfg, params, batch, device="cpu")
    enc_out = encode(cfg, params, batch["enc_frames"], device="cpu") if cfg.encoder else None
    cache = init_cache(cfg, 1, 96, device="cpu")
    steps = []
    for i in range(n):
        lg, cache = decode_step(cfg, params, cache, batch["tokens"][:, i : i + 1], i,
                                enc_out=enc_out, device="cpu")
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=DECODE_VS_FORWARD_TOL, rtol=DECODE_VS_FORWARD_TOL)


# --------------------------- encoder and cross-attention --------------------


def _whisper(dtype):
    jcfg, cfg = _cfgs("whisper_base", dtype)
    jparams = jax_init_params(jcfg, seed=3)
    return jcfg, cfg, jparams, params_from_jax(cfg, _numpy_tree(jparams), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_apply_matches_the_reference(dtype):
    """Decoder states (S 24) against encoder states (T 32); no rope, no qk-norm."""
    jcfg, cfg, jparams, params = _whisper(dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 32, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["u0"]["cross"])
    p = {k: v[0] for k, v in params["blocks"]["u0"]["cross"].items()}
    want = jax.jit(lambda p_, x_, e_: jax_attention.cross_attn_apply(p_, jcfg, x_, e_, impl="ref"))(
        jp, jnp.asarray(x, dtype), jnp.asarray(enc, dtype))
    dt = getattr(torch, dtype)
    got = attention.cross_attn_apply(p, cfg, torch.from_numpy(x).to(dt),
                                     torch.from_numpy(enc).to(dt), impl="ref")
    assert got.dtype == dt and got.shape == (B, 24, cfg.d_model)
    _close(got.float().numpy(), np.asarray(want, np.float32), LAYER_TOL[dtype], "cross")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_the_reference(dtype):
    jcfg, cfg, jparams, params = _whisper(dtype)
    frames = np.random.default_rng(5).standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, f: jax_transformer._run_encoder(jcfg, p, f.astype(jcfg.dtype), "ref"))(
        jparams, jnp.asarray(frames))
    got = encode(cfg, params, frames, device="cpu")
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, cfg.encoder.n_frames, cfg.d_model)
    _close(got.float().numpy(), np.asarray(want, np.float32), LAYER_TOL[dtype], "encoder")


def test_encoder_output_reaches_every_decoder_position():
    """Changing one frame moves the logits of every text position (the
    cross-attention sees all frames, with no causal mask), and moves nothing
    when the config has no encoder input to read."""
    _, cfg, _, params = _whisper("float32")
    batch = _batch(cfg, seed=6, S=8)
    base, _ = forward(cfg, params, batch, device="cpu")
    frames = batch["enc_frames"].copy()
    frames[:, -1] += 1.0
    moved, _ = forward(cfg, params, dict(batch, enc_frames=frames), device="cpu")
    assert bool((moved - base).abs().amax(-1).gt(1e-6).all())


# (Sq, Sk, Hq, Hkv): cross-attention shapes the reference's 128-row blocks
# divide (Sq = 1 is a decode step), with and without GQA
NON_CAUSAL = [(24, 32, 2, 2), (1, 32, 2, 2), (16, 48, 4, 2), (1, 16, 4, 1)]


@pytest.mark.parametrize("case", NON_CAUSAL,
                         ids=[f"Sq{c[0]}_Sk{c[1]}_g{c[2] // c[3]}" for c in NON_CAUSAL])
def test_attention_ref_matches_the_references_kernel_non_causal(case):
    Sq, Sk, Hq, Hkv = case
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Sq, Hq, 64)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, 64)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, 64)).astype(np.float32)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                               interpret=True)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)


# ------------------------------- vision stub --------------------------------


def test_vision_positions_are_cut_and_feed_the_text():
    """phi-3-vision: the logits are the text positions' only; the image
    positions come first (the causal mask runs over the concatenation), so
    each text position reads them."""
    _, cfg = _cfgs("phi3_vision_4_2b")
    params = init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, seed=8, S=8)
    base, _ = forward(cfg, params, batch, device="cpu")
    assert base.shape == (B, 8, cfg.vocab_size)
    img = batch["img_embeds"].copy()
    img[:, -1] += 1.0
    moved, _ = forward(cfg, params, dict(batch, img_embeds=img), device="cpu")
    assert bool((moved - base).abs().amax(-1).gt(1e-6).all())
    no_img, _ = forward(cfg, params, {"tokens": batch["tokens"]}, device="cpu")
    assert no_img.shape == base.shape and not torch.equal(no_img, base)


def test_modality_inputs_on_another_device_raise():
    _, cfg = _cfgs("phi3_vision_4_2b")
    params = init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, S=4)
    batch["img_embeds"] = torch.from_numpy(batch["img_embeds"]).to("meta")
    with pytest.raises(ValueError, match="lies on meta"):
        forward(cfg, params, batch, device="cpu")
    _, wcfg = _cfgs("whisper_base")
    wparams = init_params(wcfg, seed=0, device="cpu")
    cache = init_cache(wcfg, 1, 4, device="cpu")
    enc = torch.zeros((1, 4, wcfg.d_model), device="meta")
    with pytest.raises(ValueError, match="enc_out lies on meta"):
        decode_step(wcfg, wparams, cache, np.zeros((1, 1), np.int64), 0, enc_out=enc, device="cpu")
    with pytest.raises(ValueError, match="no encoder"):
        encode(cfg, params, batch["img_embeds"], device="cpu")


# ---------------------------- entry points ----------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_on_cpu(arch):
    """``launch.serve`` decodes without ``enc_out``, as the reference's
    ``serve`` does; mixtral and nemotron also cut to one of their layers."""
    tps = serve(ALIASES[arch], smoke=True, steps=3, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0
    if arch in ("mixtral_8x7b", "nemotron_4_340b"):
        assert serve(arch, smoke=True, steps=3, n_layers=1, device="cpu", verbose=False) > 0


@pytest.mark.parametrize("arch", ["whisper_base", "phi3_vision_4_2b"])
def test_train_smoke_on_cpu_with_the_references_batches(arch):
    """``launch.train`` takes the modality inputs that ``SyntheticLM`` makes,
    which equal the reference's arrays."""
    cfg = smoke_config(arch)
    want = JaxSyntheticLM(jax_smoke_config(arch), 2, 48, seed=0).batch_for_step(1)
    got = SyntheticLM(cfg, 2, 48, seed=0).batch_for_step(1)
    assert got.keys() == want.keys() and ("enc_frames" in got or "img_embeds" in got)
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
    _, losses = train(arch, steps=2, smoke=True, global_batch=2, seq_len=48, verbose=False,
                      device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
