"""The plain references against the program at the smoke presets' sizes, both
in fp32 on the CPU: prefill logits, decode steps through the program's
cache, capacity drops, and the kept copies the reference records for K4's
bound."""

import dataclasses
import json

import pytest
import torch
from conftest import BENCH, DATA

from repro_torch.configs import smoke_config
from repro_torch.models import abstract_params, decode_step, forward, init_cache
from yardstick.model import shape_of
from yardstick.runner import load_module
from yardstick.weights import make_weights

CASES = [("mixtral-smoke", "mixtral-8x7b", "mixtral-8x7b"),
         ("jamba-smoke", "jamba-v0.1-52b", "jamba-v0.1-52b")]
CPU = torch.device("cpu")
# fp32 on both sides; the sums differ in order only (the chunked scan, blocked attention)
TOL = 1e-4


def _setup(conf_name, registry, ref_name, capacity_factor=None):
    shape = shape_of(json.loads((DATA / f"{conf_name}.json").read_text()))
    cfg = dataclasses.replace(smoke_config(registry), n_layers=shape.n_layers, dtype="float32",
                              param_dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
        shape = dataclasses.replace(shape, capacity_factor=capacity_factor)
    weights = make_weights(abstract_params(cfg), 11, CPU, shape.d)
    ref = load_module(BENCH / "reference" / f"{ref_name}.py")
    return cfg, shape, weights, ref


def _logits(h, weights):
    return h @ weights["unembed"].float().t()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["published", "dropping"])
def test_prefill_logits(case, capacity_factor):
    cfg, shape, w, ref = _setup(*case, capacity_factor=capacity_factor)
    toks = torch.randint(0, shape.vocab, (1, 96), generator=torch.Generator().manual_seed(3))
    got, _ = forward(cfg, w, {"tokens": toks}, impl="ref", device="cpu")
    want = _logits(ref.final_hidden(shape, w, toks, groups="batch"), w)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["published", "dropping"])
def test_decode_through_the_cache(case, capacity_factor):
    cfg, shape, w, ref = _setup(*case, capacity_factor=capacity_factor)
    B, n = 8, 20
    toks = torch.randint(0, shape.vocab, (B, n), generator=torch.Generator().manual_seed(4))
    cache = init_cache(cfg, B, 32, device="cpu")
    steps = []
    for i in range(n):
        logits, cache = decode_step(cfg, w, cache, toks[:, i : i + 1], i, impl="ref", device="cpu")
        steps.append(logits[:, 0])
    got = torch.stack(steps, dim=1)
    want = _logits(ref.final_hidden(shape, w, toks, groups="position"), w)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("groups", ["batch", "position"])
def test_recorded_routing_counts_the_kept_copies(case, groups):
    """Every MoE layer records, a dispatch group, the copies each expert kept:
    at most the capacity an expert, all copies where the capacity is ample,
    fewer where it drops."""
    from yardstick import plain

    B, S = (1, 96) if groups == "batch" else (8, 12)
    toks = torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(5))
    kept = {}
    for factor in (0.5, 4.0):
        _, shape, w, ref = _setup(*case, capacity_factor=factor)
        with plain.record_routing() as routing:
            ref.final_hidden(shape, w, toks, groups=groups)
        per_group = B * S if groups == "batch" else B
        cap = -(-per_group * shape.top_k * factor // shape.experts)
        assert len(routing) == shape.moe_layers
        for counts in routing:
            assert counts.shape == ((1 if groups == "batch" else S), shape.experts)
            assert int(counts.max()) <= cap
        kept[factor] = sum(int(c.sum()) for c in routing)
    assert kept[4.0] == shape.moe_layers * B * S * shape.top_k
    assert kept[0.5] < kept[4.0]
    with plain.record_routing() as routing:  # the control's low-precision pass records nothing
        ref.final_hidden(shape, w, toks, groups=groups, lowp=True)
    assert routing == []


def test_drops_happen_at_the_low_capacity():
    """The dropping cases above do drop copies (else they would test nothing)."""
    _, shape, w, _ = _setup(*CASES[0], capacity_factor=0.5)
    from yardstick import plain
    from yardstick.weights import layer_view

    x = torch.randn(1, 96, shape.d, generator=torch.Generator().manual_seed(6))
    p = layer_view(w, 0)["moe"]
    full = plain.moe_block(x, layer_view(w, 0)["norm2"]["scale"], p, dataclasses.replace(
        shape, capacity_factor=4.0), "batch", False)
    cut = plain.moe_block(x, layer_view(w, 0)["norm2"]["scale"], p, shape, "batch", False)
    changed = (full - cut).abs().amax(dim=-1)[0] > 0
    assert 0 < int(changed.sum()) < 96
    assert not bool(changed[:8].any())  # the first tokens are never dropped
