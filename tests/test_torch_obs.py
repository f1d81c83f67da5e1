"""The model step's spans and its ``rt.moe.copies`` counter (:mod:`repro_torch.obs`), on the CPU.

Smoke configs of mixtral (a MoE on every attention layer) and jamba (mamba
mixers, one attention layer, MoE on odd layers; two repeats of its unit) at
``impl="ref"`` and fp32. With no profiler recording nothing is entered or
kept; under ``torch.profiler.profile`` every call, layer and MoE sub-layer
has its span in the exported Chrome trace, each MoE layer call leaves one
sample, and the values computed are the same bits either way.
"""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import moe as moe_module
from repro_torch.tree import leaves

B, S, CACHE = 2, 16, 24
ARCHS = ("mixtral-8x7b", "jamba-v0.1-52b")
LAYER_SPANS = {"attn": "rt.layer.attention", "local": "rt.layer.attention", "mamba": "rt.layer.mamba",
               "mlstm": "rt.layer.mlstm", "slstm": "rt.layer.slstm"}
MOE_PARTS = ("rt.moe.route", "rt.moe.dispatch", "rt.moe.experts", "rt.moe.combine")


def _model(arch, **moe_kw):
    cfg = smoke_config(arch)
    kw = {"dtype": "float32", "param_dtype": "float32", "remat": "none"}
    if arch == "jamba-v0.1-52b":
        kw["n_layers"] = 16
    if moe_kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe_kw)
    cfg = dataclasses.replace(cfg, **kw)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _tokens(cfg, seed, shape=(B, S)):
    return torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator().manual_seed(seed))


def _moe_layers(cfg):
    return sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))


def _run(cfg, params, entry, seed=1):
    """(logits, cache or None) of one ``forward`` over B x S tokens, or of
    three ``decode_step`` calls from an empty cache (the last one's logits)."""
    if entry == "forward":
        return forward(cfg, params, {"tokens": _tokens(cfg, seed)}, impl="ref", device="cpu")[0], None
    cache = init_cache(cfg, B, CACHE, device="cpu")
    toks = _tokens(cfg, seed, (B, 3))
    for i in range(3):
        logits, cache = decode_step(cfg, params, cache, toks[:, i : i + 1], i, impl="ref", device="cpu")
    return logits, cache


def _spans(prof, tmp_path):
    """The ``rt.*`` spans of the profile's Chrome trace: (name, start, end) in us."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e["name"]).startswith("rt.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def fresh(monkeypatch):
    """A stretch state of the test's own: no samples kept, no profiler seen."""
    monkeypatch.setattr(obs, "_STRETCH", obs._Stretch())


@pytest.mark.parametrize("arch", ARCHS)
def test_no_profiler_enters_no_span_and_keeps_no_sample(arch, fresh, monkeypatch):
    cfg, params = _model(arch)
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for entry in ("forward", "decode_step"):
        _run(cfg, params, entry)
    assert entered == []
    assert obs.samples("rt.moe.copies") == []
    with profile(activities=[ProfilerActivity.CPU]):  # the same counter sees spans when one records
        _run(cfg, params, "forward")
    assert "rt.forward" in entered


@pytest.mark.parametrize("arch", ARCHS + ("xlstm-350m",))
@pytest.mark.parametrize("entry", ["forward", "decode_step"])
def test_profiled_call_has_its_spans(arch, entry, fresh, tmp_path):
    cfg, params = _model(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(cfg, params, entry)
    spans = _spans(prof, tmp_path)
    calls = 1 if entry == "forward" else 3
    steps = [s for s in spans if s[0] == f"rt.{entry}"]
    assert len(steps) == calls
    layers = [s for s in spans if s[0].startswith("rt.layer.")]
    want = sorted(LAYER_SPANS[k] for k in cfg.layer_kinds()) * calls
    assert sorted(s[0] for s in layers) == sorted(want)
    assert all(any(_inside(s, st) for st in steps) for s in layers)
    assert sum(s[0] == "rt.logits" for s in spans) == calls
    moes = [s for s in spans if s[0] == "rt.moe"]
    assert len(moes) == _moe_layers(cfg) * calls
    for part in MOE_PARTS:
        inner = [s for s in spans if s[0] == part]
        assert len(inner) == len(moes)
        assert all(sum(_inside(s, m) for s in inner) == 1 for m in moes)
    assert all(any(_inside(m, lay) for lay in layers) for m in moes)
    kinds = list(cfg.layer_kinds())
    assert sum(s[0] == "rt.attention" for s in spans) == calls * sum(k in ("attn", "local") for k in kinds)
    assert sum(s[0] == "rt.mamba" for s in spans) == calls * kinds.count("mamba")
    dense = sum(not cfg.layer_is_moe(i) for i, k in enumerate(kinds) if k in ("attn", "local", "mamba"))
    assert sum(s[0] == "rt.mlp" for s in spans) == calls * (dense if cfg.d_ff > 0 else 0)


def _kept_by_the_queue(x, router, k, capacity):
    """(copies each expert got, copies kept) from the top-k of ``x``'s router
    probabilities, each expert's queue taken in token order and cut at
    ``capacity``, as the reference's cumulative-sum dispatch does."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router, dim=-1)
    onehot = torch.nn.functional.one_hot(torch.topk(probs, k, dim=-1).indices, probs.shape[-1])
    queue = onehot.reshape(-1, probs.shape[-1])  # (T*k, E), copies in token order
    place = ((torch.cumsum(queue, dim=0) - 1) * queue).sum(-1)
    return queue.sum(0).tolist(), int((place < capacity).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["no_drops", "drops"])
def test_copies_count_the_kept_rows(arch, capacity_factor, fresh, monkeypatch):
    cfg, params = _model(arch, capacity_factor=capacity_factor)
    seen = []
    real = moe_module._moe_local

    def watched(p, cfg_, x, impl, e0=0):
        seen.append((x.clone(), p["router"]))
        return real(p, cfg_, x, impl, e0=e0)

    monkeypatch.setattr(moe_module, "_moe_local", watched)
    with profile(activities=[ProfilerActivity.CPU]):
        _run(cfg, params, "forward", seed=1)
        _run(cfg, params, "forward", seed=2)
    got = obs.samples("rt.moe.copies")
    assert len(got) == len(seen) == _moe_layers(cfg) * 2
    dropped = 0
    for (counts, capacity), (x, router) in zip(got, seen, strict=True):
        want_counts, want_kept = _kept_by_the_queue(x, router, cfg.moe.top_k, capacity)
        assert counts == want_counts and isinstance(capacity, int)
        assert sum(min(c, capacity) for c in counts) == want_kept
        dropped += sum(counts) - want_kept
    assert (dropped > 0) == (capacity_factor < 1)

    _run(cfg, params, "forward", seed=3)  # unprofiled: keeps nothing, ends the stretch
    assert len(obs.samples("rt.moe.copies")) == len(got)
    with profile(activities=[ProfilerActivity.CPU]):  # a second stretch restarts the samples
        _run(cfg, params, "decode_step")
    again = obs.samples("rt.moe.copies")
    assert len(again) == _moe_layers(cfg) * 3
    assert all(sum(c) == B * cfg.moe.top_k for c, _ in again)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("entry", ["forward", "decode_step"])
def test_the_profiler_changes_no_bit(arch, entry, fresh):
    cfg, params = _model(arch)
    plain_logits, plain_cache = _run(cfg, params, entry)
    with profile(activities=[ProfilerActivity.CPU]):
        logits, cache = _run(cfg, params, entry)
    assert torch.equal(logits, plain_logits)
    if cache is not None:
        assert all(torch.equal(a, b) for a, b in zip(leaves(cache), leaves(plain_cache), strict=True))
