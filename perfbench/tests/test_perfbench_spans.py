"""The readers of the program's spans and counter (``yardstick/spans.py`` and
the eight metrics on it) on traces and samples built by hand: idle gaps put
down to ``rt.*`` spans, the shares adding up to the slice's idle share, and
K4's roofline over the program's own kept rows."""

import json
import sys
from types import SimpleNamespace

import pytest
from conftest import BENCH

from yardstick import shares, spans
from yardstick.model import shape_of
from yardstick.runner import load_module
from yardstick.trace import Trace

MIXTRAL = shape_of(json.loads((BENCH / "configs" / "mixtral-8x7b.json").read_text()))
IDLE = {name: load_module(BENCH / "metrics" / f"{name}.py") for name in (
    "moe_idle_share.prefill", "moe_idle_share.decode", "mamba_idle_share.decode",
    "attention_idle_share.decode", "driver_idle_share.prefill", "driver_idle_share.decode",
    "idle_share.prefill", "idle_share.decode")}
K4 = ("gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel")


def _trace(window_s=12.0):
    """Two decode steps, at 0.5-5.0 s and 5.5-10.0 s of the slice. Each is
    tiled by its attention, mamba and MoE spans (1.5 s each), and in each
    sub-layer the device idles 0.5 s between two operations. The driver's
    0.5 s lies between the steps, the slice's edges before 0.5 s and after
    10.0 s."""
    host, ops = [], []
    for t0 in (0.5, 5.5):
        host.append(("rt.decode_step", t0, 4.5))
        for i, name in enumerate(("rt.attention", "rt.mamba", "rt.moe")):
            start = t0 + 1.5 * i
            host.append((name, start, 1.5))
            ops += [("k", start, 0.5), ("k", start + 1.0, 0.5)]
        host += [("rt.moe.route", t0 + 3.0, 0.5), ("aten::mm", t0 + 3.6, 0.1)]
    return Trace(ops=ops, host=host, window_s=window_s)


def _ctx(kind="decode", trace=None):
    return SimpleNamespace(kind=kind, shape=MIXTRAL, trace=trace or _trace(), traced=[1, 2],
                           routed=None, batch=64, notes=[])


def test_known_idle_inside_each_span_and_outside_the_step():
    ctx = _ctx()
    tr = ctx.trace
    assert tr.busy_s == pytest.approx(6.0)
    for name in ("rt.attention", "rt.mamba", "rt.moe"):
        assert spans.idle_in(tr, [name]) == pytest.approx(2 * 0.5)
    assert spans.idle_in(tr, ["rt.decode_step"]) == pytest.approx(3.0)
    assert spans.idle_in(tr, ["rt.moe.route"]) == pytest.approx(0.0)  # a span holding no gap
    for name in ("attention_idle_share.decode", "mamba_idle_share.decode", "moe_idle_share.decode"):
        assert IDLE[name].read(ctx) == pytest.approx(100 * 1.0 / 12)
    # idle 12 - 6 = 6 s, 3 s of it in the steps: 0.5 s between them and 2.5 s of edges
    assert IDLE["driver_idle_share.decode"].read(ctx) == pytest.approx(100 * 3.0 / 12)
    assert IDLE["idle_share.decode"].read(ctx) == pytest.approx(50.0)


def test_a_gap_inside_the_moe_is_the_moes():
    host = [("rt.decode_step", 0.0, 10.0), ("rt.moe", 2.0, 6.0), ("rt.moe.dispatch", 3.0, 1.0)]
    ops = [("k", 0.0, 2.5), ("k", 3.5, 1.0), ("k", 9.0, 1.0)]  # gaps 2.5-3.5 and 4.5-9.0, in the MoE
    ctx = _ctx(trace=Trace(ops=ops, host=host, window_s=10.0))
    assert IDLE["moe_idle_share.decode"].read(ctx) == pytest.approx(55.0)
    assert IDLE["driver_idle_share.decode"].read(ctx) == pytest.approx(0.0)
    ctx.kind = "prefill"
    ctx.trace = Trace(ops=ops, host=[("rt.forward", 0.0, 10.0)] + host[1:], window_s=10.0)
    assert IDLE["moe_idle_share.prefill"].read(ctx) == pytest.approx(55.0)
    assert IDLE["driver_idle_share.prefill"].read(ctx) == pytest.approx(0.0)
    assert IDLE["moe_idle_share.decode"].read(ctx) is None


@pytest.mark.parametrize("window_s", [9.5, 12.0, 20.0])
def test_the_shares_add_up_to_the_idle_share_when_the_spans_tile_the_step(window_s):
    ctx = _ctx(trace=_trace(window_s))
    parts = [IDLE[n].read(ctx) for n in ("attention_idle_share.decode", "mamba_idle_share.decode",
                                         "moe_idle_share.decode", "driver_idle_share.decode")]
    assert sum(parts) == pytest.approx(IDLE["idle_share.decode"].read(ctx))


@pytest.mark.parametrize("name", sorted(n for n in IDLE if not n.startswith("idle_share")))
def test_no_spans_or_no_device_operations_read_none(name):
    kind = name.rsplit(".", 1)[1]
    bare = _trace()
    no_spans = Trace(ops=bare.ops, host=[("aten::mm", 0.0, 1.0)], window_s=bare.window_s)
    assert IDLE[name].read(_ctx(kind, trace=no_spans)) is None
    no_ops = Trace(ops=[], host=bare.host + [("rt.forward", 0.0, 10.0)], window_s=bare.window_s)
    assert IDLE[name].read(_ctx(kind, trace=no_ops)) is None


class _K4Trace:
    def device_seconds(self, kernels):
        return 1e-3 if tuple(kernels) == K4 else 0.0

    def count(self, kernels):
        return 3


def _samples(routed, E=8, dropped=17):
    """Samples of (copies each expert got, capacity) that keep ``rows`` copies
    and reach ``experts`` experts: the rows spread over them, the capacity the
    largest share, and ``dropped`` copies more routed to the first, past it."""
    out = []
    for layers in routed:
        for rows, experts in layers:
            counts = [rows // experts + (i < rows % experts) if i < experts else 0 for i in range(E)]
            capacity = max(counts)
            counts[0] += dropped
            out.append((counts, capacity))
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_the_program_reader_equals_the_reference_reader_on_the_same_rows(kind, monkeypatch):
    from repro_torch import obs

    routed = [[(14000, 8)] * 16, [(900, 7)] * 16]
    ctx = _ctx(kind, trace=_K4Trace())
    ctx.routed = routed
    samples = _samples(routed)
    assert spans.kept_rows(ctx, samples, "x") == routed
    monkeypatch.setattr(obs, "samples", lambda name: samples if name == "rt.moe.copies" else [])
    program = load_module(BENCH / "metrics" / f"gmm_roofline_program.{kind}.py")
    reference = load_module(BENCH / "metrics" / f"gmm_roofline.{kind}.py")
    want = reference.read(ctx)
    assert want == pytest.approx(shares.roofline(ctx, "x", K4, shares.gmm_work))
    ctx.routed = None  # the program's reader takes no rows from the check
    assert program.read(ctx) == want


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("count", [0, 31, 33])
def test_the_program_reader_reads_none_on_a_count_mismatch(kind, count, monkeypatch):
    from repro_torch import obs

    ctx = _ctx(kind, trace=_K4Trace())  # two traced items x 16 MoE layers = 32 samples
    monkeypatch.setattr(obs, "samples", lambda name: [([1] * 8, 4)] * count)
    reader = load_module(BENCH / "metrics" / f"gmm_roofline_program.{kind}.py")
    assert reader.read(ctx) is None
    assert ctx.notes and f"{count} samples" in ctx.notes[-1]
    monkeypatch.setattr(obs, "samples", lambda name: [([1] * 8, 4)] * 32)
    assert reader.read(ctx) is not None


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_program_without_the_counter_reads_none(kind, monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # the import fails, as on a tree without it
    reader = load_module(BENCH / "metrics" / f"gmm_roofline_program.{kind}.py")
    assert reader.read(_ctx(kind, trace=_K4Trace())) is None
