"""The traffic generator: the same seed gives the same requests, another seed
other ones, and every seed the same set of sizes."""

import json

import torch
from conftest import BENCH

from yardstick.traffic import DecodeTraffic, PrefillTraffic, make_traffic

CPU = torch.device("cpu")
PREFILL = json.loads((BENCH / "traffic" / "prefill-mix.json").read_text())
DECODE = json.loads((BENCH / "traffic" / "decode-64.json").read_text())
SEED = 2**31 + 977  # more than 32 signed bits, as the driver's seeds are


def _prompts(seed, n=24):
    t = PrefillTraffic(dict(PREFILL, pool_tokens=1 << 16), seed, 32000, CPU)
    out = []
    for _ in range(n):
        length, off = t.next()
        out.append((length, t.tokens(length, off).clone()))
    return out


def test_prefill_repeats_for_a_seed_and_differs_across_seeds():
    a, b, c = _prompts(SEED), _prompts(SEED), _prompts(SEED + 1)
    assert [n for n, _ in a] == [n for n, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert [n for n, _ in a] != [n for n, _ in c] or not all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, c))
    assert not torch.equal(a[0][1][:, :64], c[0][1][:, :64])


def test_prefill_cycles_are_the_mix_in_another_order():
    lengths = [n for n, _ in _prompts(SEED, 24)]
    for k in range(3):
        assert sorted(lengths[8 * k : 8 * k + 8]) == sorted(PREFILL["lengths"])
    assert lengths[:8] != lengths[8:16] or lengths[8:16] != lengths[16:24]


def test_prefill_ids_cover_the_vocabulary():
    t = PrefillTraffic(dict(PREFILL, pool_tokens=1 << 20), SEED, 32000, CPU)
    assert int(t.pool.min()) >= 0 and int(t.pool.max()) < 32000
    assert t.pool.unique().numel() > 31000


def test_decode_first_tokens_repeat_and_differ():
    a = DecodeTraffic(DECODE, SEED, 65536, CPU)
    b = DecodeTraffic(DECODE, SEED, 65536, CPU)
    c = DecodeTraffic(DECODE, SEED + 1, 65536, CPU)
    first = a.first_tokens()
    assert first.shape == (64, 1)
    assert torch.equal(first, b.first_tokens())
    assert not torch.equal(first, c.first_tokens())
    assert not torch.equal(a.first_tokens(), first)  # a new request draws new tokens


def test_unknown_kind_is_refused():
    try:
        make_traffic({"kind": "open-loop"}, 0, 10, CPU)
    except ValueError as e:
        assert "open-loop" in str(e)
    else:
        raise AssertionError("an unknown kind must be refused")
