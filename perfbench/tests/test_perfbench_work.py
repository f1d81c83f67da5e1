"""The yardstick's arithmetic against values worked by hand at the shapes of
mixtral-8x7b (16 layers) and jamba-v0.1-52b (16 layers)."""

import json

import pytest
from conftest import BENCH

from yardstick import work
from yardstick.model import shape_of
from yardstick.runner import load_module


def _shape(name):
    return shape_of(json.loads((BENCH / "configs" / f"{name}.json").read_text()))


MIXTRAL, JAMBA = _shape("mixtral-8x7b"), _shape("jamba-v0.1-52b")


def test_peaks_are_the_h100_datasheet():
    assert (work.PEAK_BF16, work.PEAK_FP32, work.HBM_BW) == (989e12, 67e12, 3.35e12)


def test_attended_pairs_window_and_causal():
    # the first 4,096 queries see 1..4,096 keys, the other 4,096 see 4,096 each
    assert work.attended_pairs(8192, 8192, True, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    assert work.attended_pairs(2048, 2048, True, None) == 2048 * 2049 // 2
    assert work.attended_pairs(4, 4, False, None) == 16


def test_layer_plans():
    assert MIXTRAL.layers == (("attention", True),) * 16
    kinds = [k for k, _ in JAMBA.layers]
    assert [i for i, k in enumerate(kinds) if k == "attention"] == [4, 12]
    assert [i for i, (_, m) in enumerate(JAMBA.layers) if m] == list(range(1, 16, 2))
    assert (JAMBA.mamba_inner, JAMBA.mamba_dt_rank, JAMBA.dense_ff, MIXTRAL.dense_ff) == (8192, 256, 14336, 0)


def test_active_params_by_hand():
    attn = 4096 * 4096 * 2 + 2 * 4096 * 1024
    norms = 2 * 4096
    mixtral_moe = 2 * 3 * 4096 * 14336 + 4096 * 8
    assert work.active_params(MIXTRAL) == 16 * (attn + mixtral_moe + norms) + 32000 * 4096
    mamba = 4096 * 16384 + 8192 * 4 + 8192 * (256 + 32) + 256 * 8192 + 8192 * 16 + 8192 * 4096
    jamba_moe = 2 * 3 * 4096 * 14336 + 4096 * 16
    dense = 3 * 4096 * 14336
    assert work.active_params(JAMBA) == (14 * mamba + 2 * attn + 8 * jamba_moe + 8 * dense + 16 * norms
                                         + 65536 * 4096)
    assert work.active_params(MIXTRAL) == 6_439_960_576
    assert work.active_params(JAMBA) == 6_054_805_504


def test_step_model_flops_by_hand():
    pairs = 8192 * 8193 // 2  # causal over the whole prompt, as published
    want = 2 * 6_439_960_576 * 8192 + 4 * 32 * 128 * pairs * 16
    assert work.step_model_flops(MIXTRAL, 8192) == pytest.approx(want, rel=1e-15)
    want = 2 * 6_054_805_504 * 1024 + 4 * 32 * 128 * (1024 * 1025 // 2) * 2
    assert work.step_model_flops(JAMBA, 1024) == pytest.approx(want, rel=1e-15)
    # a decode step: 64 tokens, each attending 100 keys in every attention layer
    assert work.decode_model_flops(JAMBA, 64, 100) == pytest.approx(
        64 * (2 * 6_054_805_504 + 4 * 32 * 128 * 100 * 2), rel=1e-15)


def test_gmm_work_counts_the_kept_rows():
    # 8,192 tokens, 14,000 of their 16,384 copies kept, all 8 experts reached
    up, gate, down = work.moe_products(MIXTRAL, 14000, 8)
    rows = 14000
    assert up == gate == (2 * rows * 4096 * 14336, 2 * (rows * 4096 + 8 * 4096 * 14336) + 4 * rows * 14336)
    assert down == (2 * rows * 14336 * 4096, 2 * (rows * 14336 + 8 * 14336 * 4096) + 2 * rows * 4096)
    # a decode step of 64 tokens, 120 of 128 copies kept: bound by reading the 8 experts' weights
    t, side = work.least_seconds(*work.moe_products(MIXTRAL, 120, 8)[0], work.PEAK_BF16)
    assert side == "bytes" and t == pytest.approx((2 * (120 * 4096 + 8 * 4096 * 14336) + 4 * 120 * 14336) / 3.35e12)
    # an expert that keeps no row is not read
    assert work.moe_products(JAMBA, 10, 5)[0][1] == 2 * (10 * 4096 + 5 * 4096 * 14336) + 4 * 10 * 14336


def test_the_k4_reader_takes_the_rows_the_check_kept():
    from types import SimpleNamespace

    from yardstick import shares

    class Trace:
        def device_seconds(self, kernels):
            return 1e-3

        def count(self, kernels):
            return 3

    kept = [[(14000, 8)] * 16, [(900, 7)] * 16]
    ctx = SimpleNamespace(kind="prefill", shape=MIXTRAL, trace=Trace(), traced=[8192, 1024],
                          routed=kept, notes=[])
    want = sum(16 * sum(work.least_seconds(f, b, work.PEAK_BF16)[0] for f, b in work.moe_products(MIXTRAL, r, e))
               for r, e in [(14000, 8), (900, 7)])
    assert shares.roofline(ctx, "gmm", ("k",), shares.gmm_work) == pytest.approx(100 * want / 1e-3)
    reader = load_module(BENCH / "metrics" / "gmm_roofline.prefill.py")
    assert reader.read(SimpleNamespace(**{**vars(ctx), "routed": None})) is None


def test_scan_and_attention_work_by_hand():
    ops, nbytes = work.scan_work(1, 8192, 8192, 16)
    assert ops == 7 * 8192 * 8192 * 16 + 3 * 8192 * 8192
    assert nbytes == 3 * 8192 * 8192 * 2 + 2 * 8192 * 16 * 2 + 4 * (8192 * 16 + 8192)
    flops, nbytes = work.attention_work(1, 8192, 8192, 32, 8, 128, True, 4096)
    assert flops == 4 * 128 * 32 * (4096 * 4097 // 2 + 4096 * 4096)
    assert nbytes == 2 * 128 * (2 * 8192 * 32 + 2 * 8192 * 8)
    assert work.least_seconds(flops, nbytes, work.PEAK_BF16)[1] == "operations"
