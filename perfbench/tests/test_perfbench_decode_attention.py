"""The decode attention's roofline reader (metrics/decode_attention_roofline.decode.py)
against values worked by hand at mixtral-8x7b's decode cell: 64 streams, 32/8
heads of 128, 16 attention layers."""

import json
from types import SimpleNamespace

import pytest
from conftest import BENCH

from yardstick import work
from yardstick.model import shape_of
from yardstick.runner import load_module

MIXTRAL = shape_of(json.loads((BENCH / "configs" / "mixtral-8x7b.json").read_text()))
READER = load_module(BENCH / "metrics" / "decode_attention_roofline.decode.py")


class _Trace:
    """K5's kernels took ``seconds`` of device time, or the trace holds none."""

    def __init__(self, seconds):
        self.seconds = seconds

    def device_seconds(self, kernels):
        assert tuple(kernels) == ("decode_attn_split_kernel", "decode_attn_combine_kernel")
        return self.seconds

    def count(self, kernels):
        return 16 if self.seconds else 0


def _ctx(seconds, kind="decode", traced=(430, 431)):
    return SimpleNamespace(kind=kind, shape=MIXTRAL, trace=_Trace(seconds), traced=list(traced), batch=64,
                           notes=[])


def test_a_layer_at_430_slots_moves_its_filled_cache_once():
    flops, nbytes = work.attention_work(64, 1, 430, 32, 8, 128, False, None)
    assert nbytes == 2 * 128 * (2 * 64 * 32 + 2 * 64 * 430 * 8) == 113_770_496
    assert flops == 4 * 128 * 64 * 32 * 430
    assert work.least_seconds(flops, nbytes, work.PEAK_BF16)[1] == "bytes"


def test_the_reader_bounds_every_layer_of_every_traced_step():
    ctx = _ctx(2e-3)
    want = sum(16 * 2 * 128 * (2 * 64 * 32 + 2 * 64 * n * 8) / work.HBM_BW for n in (430, 431))
    assert READER.read(ctx) == pytest.approx(100 * want / 2e-3)
    assert "set by bytes" in ctx.notes[0] and "in 16 launches" in ctx.notes[0]


def test_the_reader_finds_nothing_without_k5_or_outside_decode():
    assert READER.read(_ctx(0.0)) is None  # a program without K5: its trace holds none
    assert READER.read(_ctx(2e-3, kind="prefill")) is None
    assert READER.read(_ctx(2e-3, traced=())) is None
