"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where there is no
card; this file imports no JAX, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention as fa
import repro_torch.kernels.gmm as gk
import repro_torch.kernels.mamba_scan as ms
import repro_torch.kernels.mlstm as ml
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    attention_ref,
    gmm_ref,
    mamba_scan_ref,
    mlstm_chunked_scan,
    mlstm_chunkwise_ref,
    mlstm_rounded_scan,
)

pytestmark = pytest.mark.cuda

# tests/test_kernels.py ATTN_CASES plus a ragged shape: B, Sq, Sk, Hq, Hkv, D, causal, window,
# softcap, q_offset, dtype
CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, 0, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, None, 0, "float32"),
    (1, 256, 256, 4, 1, 64, True, 128, None, 0, "float32"),
    (2, 128, 128, 4, 2, 64, False, None, 50.0, 0, "float32"),
    (1, 128, 384, 4, 2, 64, True, None, None, 256, "float32"),
    (1, 256, 256, 2, 2, 64, True, None, None, 0, "bfloat16"),
    (1, 128, 128, 4, 4, 256, True, 64, None, 0, "float32"),
    (2, 100, 77, 4, 1, 256, True, 30, None, 5, "bfloat16"),
]
# head dims without a tile of their own on the bf16 route (80, 96 run in the
# D 128 tile, 192 in the D 256 one; the fp32 route has a D 192 tile), causal
# with GQA and windowed; Sq and Sk multiples of no tile
ODD_D_CASES = [
    (2, 200, 200, 6, 2, 80, True, None, None, 0, "float32"),
    (1, 256, 256, 4, 1, 80, True, 64, None, 0, "float32"),
    (2, 130, 130, 8, 2, 96, True, None, None, 0, "float32"),
    (1, 256, 300, 4, 4, 96, True, 100, None, 44, "float32"),
    (1, 200, 200, 4, 2, 192, True, None, None, 0, "float32"),
    (2, 128, 128, 2, 1, 192, True, 50, None, 0, "float32"),
]
CASES += ODD_D_CASES
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(card, case, seed=0):
    B, Sq, Sk, Hq, Hkv, D, *_, dtype = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card, getattr(torch, dtype))
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _kw(case):
    causal, window, softcap, q_offset = case[6:10]
    return {"causal": causal, "window": window, "softcap": softcap, "q_offset": q_offset}


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_kernel_matches_plain_version(card, case):
    q, k, v = _inputs(card, case)
    out = fa.flash_attention(q, k, v, **_kw(case))
    ref = attention_ref(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    tol = TOL[case[-1]]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_kernel_reads_strided_rows(card):
    """q, k, v as views of one fused projection: rows strided, no copies."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 6, 64)).astype(np.float32)).to(card)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    out = fa.flash_attention(q, k, v, window=40)
    torch.testing.assert_close(out, attention_ref(q, k, v, window=40), atol=2e-5, rtol=2e-5)


# the bf16 route (wgmma, TMA): a bf16 twin of every fp32 case above, then Sq and
# Sk that are multiples of neither the q tile (128) nor a kv tile (128, or 64
# at D 256), at each head dim, with q_offset, window and softcap between them
BF16_CASES = [c[:-1] + ("bfloat16",) for c in CASES[:8] if c[-1] == "float32"] + [
    (2, 300, 333, 6, 2, 64, True, None, None, 33, "bfloat16"),
    (1, 77, 200, 4, 4, 128, False, None, 30.0, 0, "bfloat16"),
    (2, 333, 300, 2, 1, 256, True, 100, None, 0, "bfloat16"),
    (1, 129, 65, 8, 2, 64, False, 40, None, 70, "bfloat16"),
] + [c[:-1] + ("bfloat16",) for c in ODD_D_CASES]
# the bf16 route's second bar (as in chip_smoke.py): row by row,
# |out - exact| / |exact| with norms over D, exact being the plain version in
# fp32 on the same bf16 inputs; rounding P and the output to bf16 reads a few
# 1e-3, P rounded to fp8 a few 1e-2
ROW_REL_TOL = 1e-2


def _row_rel(out, q, k, v, **kw):
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    return ((out.float() - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("case", BF16_CASES, ids=[f"bf16_case{i}" for i in range(len(BF16_CASES))])
def test_bf16_route_matches_plain_version(card, case):
    q, k, v = _inputs(card, case, seed=3)
    assert fa.plan(q, k, v).route == "wgmma"
    out = fa.flash_attention(q, k, v, **_kw(case))
    ref = attention_ref(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    assert _row_rel(out, q, k, v, **_kw(case)) <= ROW_REL_TOL


# the shapes the remaining one-card configs give the kernel: whisper-base's
# cross-attention (448 decoder positions against 1,500 frames, non-causal) and
# its decode step (1 against 1,500), its encoder (1,500 against 1,500,
# non-causal, ragged against every tile); gemma3-12b's local layer (GQA 2 in
# the D 256 tile, window 1,024); phi-3-vision-4.2b's 576 + 2,048 positions at
# D 96 (a ragged last tile); mixtral-8x7b's window of 4,096 at S 8,192
A5_CASES = {
    "whisper_cross": (8, 448, 1500, 8, 8, 64, False, None, None, 0),
    "whisper_decode_cross": (8, 1, 1500, 8, 8, 64, False, None, None, 0),
    "whisper_encoder": (8, 1500, 1500, 8, 8, 64, False, None, None, 0),
    "gemma3_12b_local": (2, 2048, 2048, 16, 8, 256, True, 1024, None, 0),
    "phi3_vision": (2, 2624, 2624, 32, 32, 96, True, None, None, 0),
    "mixtral_window": (1, 8192, 8192, 32, 8, 128, True, 4096, None, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(A5_CASES))
def test_kernel_at_the_a5_configs_shapes(card, name, dtype):
    case = A5_CASES[name] + (dtype,)
    q, k, v = _inputs(card, case, seed=9)
    out = fa.flash_attention(q, k, v, **_kw(case))
    ref = attention_ref(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == "bfloat16":
        del ref
        assert _row_rel(out, q, k, v, **_kw(case)) <= ROW_REL_TOL


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_bf16_route_reads_strided_rows(card, D):
    """bf16 q, k, v as views of one fused projection: TMA reads the strided rows."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 200, 6, D)).astype(np.float32)).to(card, torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    out = fa.flash_attention(q, k, v, window=90)
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, window=90).float(), atol=2e-2, rtol=2e-2)
    assert _row_rel(out, q, k, v, window=90) <= ROW_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_stores_only_its_head_dim(card, dtype):
    """D 80 runs in the D 128 tile: of each row the epilogue stores 80 columns,
    so the padding never lands on the next head. q, k, v are strided views of
    one projection; the output is a view of a buffer that holds one more head
    past it, whose bytes must stay as they were."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 150, 6, 80)).astype(np.float32)).to(card, getattr(torch, dtype))
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    p = fa.plan(q, k, v)
    assert (p.head_dim, p.tile_d) == (80, 128)
    n = q.numel()
    buf = torch.full((n + 80,), 7.0, dtype=q.dtype, device=card)
    out = buf[:n].view(q.shape)
    fa._launch(q, k, v, out, p, causal=True, window=None, softcap=None, q_offset=0, scale=None)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(buf[n:], torch.full_like(buf[n:], 7.0))
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_bf16_route_rows_that_attend_nothing_are_zero(card):
    """Keys [0, 64), a window of 100, not causal: rows from position 163 on have
    no key in reach and must return 0, beside rows of the same q tile that do."""
    q, k, v = _inputs(card, (1, 256, 64, 4, 2, 128, False, 100, None, 0, "bfloat16"), seed=5)
    out = fa.flash_attention(q, k, v, causal=False, window=100)
    ref = attention_ref(q, k, v, causal=False, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 163:], torch.zeros_like(out[:, 163:]))
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    q, k, v = _inputs(card, (1, 8, 4, 2, 1, 64, True, 1, None, 16, "bfloat16"))
    out = fa.flash_attention(q, k, v, window=1, q_offset=16)  # no tile in reach at all
    assert torch.equal(out, torch.zeros_like(out))


def test_bf16_route_refuses_what_tma_cannot_load(card):
    q, k, v = _inputs(card, (1, 64, 64, 2, 1, 64, True, None, None, 0, "bfloat16"))
    buf = torch.zeros(1, 64, 2 * 64 + 4, dtype=torch.bfloat16, device=card)
    q_odd = buf.as_strided((1, 64, 2, 64), (64 * 132, 132, 64, 1))  # rows 264 bytes apart
    with pytest.raises(ValueError, match="q's row stride is 264 bytes"):
        fa.flash_attention(q_odd, k, v)
    flat = torch.zeros(64 * 64 + 4, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="k starts 8 bytes past a 16-byte boundary"):
        fa.flash_attention(q, flat[4:].view(1, 64, 1, 64), v)


def test_bf16_route_counts_launches(card):
    q, k, v = _inputs(card, CASES[5])
    before = fa.LAUNCHES
    ops.attention(q, k, v, impl="auto")
    assert fa.LAUNCHES == before + 1


def test_auto_on_card_launches_the_kernel(card):
    q, k, v = _inputs(card, CASES[0])
    before = fa.LAUNCHES
    ops.attention(q, k, v, impl="auto")
    assert fa.LAUNCHES == before + 1


def test_kernel_rejects_what_it_does_not_take(card):
    q, k, v = _inputs(card, CASES[0])
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    q32, k32, v32 = _inputs(card, (1, 16, 16, 2, 1, 32, True, None, None, 0, "float32"))
    with pytest.raises(ValueError, match="head dim 32"):
        fa.flash_attention(q32, k32, v32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fa.flash_attention(q.cpu(), k, v)


# tests/test_kernels.py MAMBA_CASES (B, T, Di, N; the Pallas block sizes do not
# apply), then ragged T and Di, then the mixer's layout: B and C strided slices
# of one projection in x's dtype
MAMBA_CASES = [
    (2, 128, 256, 16, "float32", "float32"),
    (1, 256, 512, 16, "float32", "float32"),
    (2, 64, 128, 8, "float32", "float32"),
    (1, 128, 256, 16, "bfloat16", "float32"),
    (2, 77, 200, 16, "float32", "float32"),
    (3, 45, 72, 16, "bfloat16", "bfloat16"),
]
# the tolerances of tests/test_kernels.py::test_mamba_scan_matches_oracle
MAMBA_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _mamba_inputs(card, case, seed=0, strided_bc=False):
    """The inputs of tests/test_kernels.py: dt = softplus(n) * 0.1, A = -exp(0.5 n)."""
    Bsz, T, Di, N, xdt, bcdt = case
    rng = np.random.default_rng(seed)

    def t(*shape, dtype="float32"):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            card, getattr(torch, dtype))

    x = t(Bsz, T, Di, dtype=xdt)
    dt = (torch.nn.functional.softplus(t(Bsz, T, Di)) * 0.1).to(x.dtype)
    A = -torch.exp(t(Di, N) * 0.5)
    if strided_bc:
        bc = t(Bsz, T, 3 + 2 * N, dtype=bcdt)
        Bm, Cm = bc[..., 3 : 3 + N], bc[..., 3 + N :]
    else:
        Bm, Cm = t(Bsz, T, N, dtype=bcdt), t(Bsz, T, N, dtype=bcdt)
    return x, dt, A, Bm, Cm, t(Di)


@pytest.mark.parametrize("case", MAMBA_CASES, ids=[f"case{i}" for i in range(len(MAMBA_CASES))])
def test_mamba_kernel_matches_plain_version(card, case):
    args = _mamba_inputs(card, case, strided_bc=case == MAMBA_CASES[-1])
    out = ms.mamba_scan(*args)
    ref = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    tol = MAMBA_TOL[case[4]]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("n_state", [3, 8, 16, 32, ms.MAX_STATES])
def test_mamba_kernel_every_state_count(card, n_state):
    """Each count of lanes a channel's states take (4, 8, 16 lanes of 4
    states), padded where N is not a multiple of 4, gives the plain version's
    scan."""
    args = _mamba_inputs(card, (2, 40, 96, n_state, "float32", "float32"), seed=2)
    out = ms.mamba_scan(*args)
    torch.testing.assert_close(out, mamba_scan_ref(*args), atol=2e-4, rtol=2e-4)


def test_mamba_auto_on_card_launches_the_kernel(card):
    args = _mamba_inputs(card, MAMBA_CASES[2])
    before = ms.LAUNCHES
    ops.mamba_scan(*args, impl="auto")
    assert ms.LAUNCHES == before + 1


def test_mamba_kernel_rejects_what_it_does_not_take(card):
    x, dt, A, Bm, Cm, D = _mamba_inputs(card, MAMBA_CASES[2])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ms.mamba_scan(x.cpu(), dt, A, Bm, Cm, D)
    with pytest.raises(TypeError, match="float16"):
        ms.mamba_scan(x.half(), dt.half(), A, Bm, Cm, D)
    with pytest.raises(TypeError, match="A and D must be float32"):
        ms.mamba_scan(x, dt, A.double(), Bm, Cm, D)
    with pytest.raises(ValueError, match="B is"):
        ms.mamba_scan(x, dt, A, Bm[:, :-1], Cm, D)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        ms.mamba_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, D)
    x, dt, A, Bm, Cm, D = _mamba_inputs(card, (1, 8, 64, ms.MAX_STATES + 1, "float32", "float32"))
    with pytest.raises(ValueError, match="states"):
        ms.mamba_scan(x, dt, A, Bm, Cm, D)


def _slow_decay_inputs(card, Bsz, T, Di, N=16, dtype="float32", seed=0):
    """Like the mixer's init: dt log-uniform in [1e-3, 1e-1], A = -(1 .. N), so
    the state lasts hundreds of steps and a state lost anywhere in the scan
    shows above the bar (tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, getattr(torch, dt))

    x = t(Bsz, T, Di)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (Bsz, T, Di))).astype(np.float32))
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(Di, 1).to(card)
    return x, dt.to(card, x.dtype), A, t(Bsz, T, N), t(Bsz, T, N), t(Di, dt="float32")


# the slow-decay case at T 2048, then T = 1, a stage and one step either way,
# a ragged T and Di, batch 1: (B, T, Di)
SLOW_DECAY_CASES = [(2, 2048, 256), (1, 1, 64), (1, ms.STAGE - 1, 64), (1, ms.STAGE, 64),
                    (1, ms.STAGE + 1, 64), (1, 1000, 200)]


@pytest.mark.parametrize("case", SLOW_DECAY_CASES, ids=[f"slow{i}" for i in range(len(SLOW_DECAY_CASES))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_kernel_holds_a_slow_decaying_state(card, case, dtype):
    args = _slow_decay_inputs(card, *case, dtype=dtype)
    out = ms.mamba_scan(*args)
    ref = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    tol = MAMBA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_mamba_kernel_holds_the_bar_where_a_dropped_state_fails_it(card):
    """Over 2048 steps the kernel holds the fp32 bar against the plain scan;
    the plain scan with its state dropped every 128 steps fails it."""
    args = _slow_decay_inputs(card, 1, 2048, 128, seed=1)
    out = ms.mamba_scan(*args)
    ref = mamba_scan_ref(*args)
    x, dt, A, Bm, Cm, D = args
    dropped = torch.cat([mamba_scan_ref(x[:, s : s + 128], dt[:, s : s + 128], A, Bm[:, s : s + 128],
                                        Cm[:, s : s + 128], D) for s in range(0, 2048, 128)], dim=1)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)
    assert not torch.allclose(dropped, ref, atol=2e-4, rtol=2e-4)


def test_mamba_kernel_gives_the_same_bits_twice(card):
    args = _mamba_inputs(card, (2, 2048, 512, 16, "bfloat16", "bfloat16"), seed=4, strided_bc=True)
    first = ms.mamba_scan(*args)
    assert torch.equal(first, ms.mamba_scan(*args))


def test_mamba_kernel_replays_in_a_cuda_graph(card):
    """A captured call replays right, twice."""
    args = _slow_decay_inputs(card, 2, 1024, 256, dtype="bfloat16", seed=5)
    ref = ms.mamba_scan(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ms.mamba_scan(*args)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


# tests/test_kernels.py MLSTM_CASES (B, T, H, D, L); L is the plain version's
# chunk (the kernel takes its own)
MLSTM_CASES = [(2, 128, 2, 64, 64), (1, 256, 4, 64, 128), (1, 128, 1, 128, 32)]
# fp32: the relative form and bar of tests/test_kernels.py; bf16: one bf16
# rounding of the output on top (2^-8 relative)
MLSTM_TOL = {"float32": 2e-3, "bfloat16": 1e-2}


def _mlstm_inputs(card, B, T, H, D, dtype="float32", seed=0):
    """The inputs of tests/test_kernels.py: i ~ N(0, 1), f ~ N(2, 2)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0, dt="float32"):
        a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return torch.from_numpy(a).to(card, getattr(torch, dt))

    q, k, v = (t(B, T, H, D, dt=dtype) for _ in range(3))
    return q, k, v, t(B, T, H), t(B, T, H, scale=2.0, shift=2.0)


def _mlstm_rel(out, ref):
    """max |a - b| / (|b| + 1e-2), the form of tests/test_kernels.py."""
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (ref.abs() + 1e-2)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLSTM_CASES, ids=[f"case{i}" for i in range(len(MLSTM_CASES))])
def test_mlstm_kernel_matches_plain_version(card, case, dtype):
    B, T, H, D, L = case
    args = _mlstm_inputs(card, B, T, H, D, dtype)
    out = ml.mlstm_chunkwise(*args)
    ref = mlstm_chunked_scan(*args, chunk=L)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert _mlstm_rel(out, ref) < MLSTM_TOL[dtype]


def test_mlstm_kernel_masks_ragged_T(card):
    """T not a multiple of the kernel's chunk: the short last chunk is masked;
    the quadratic oracle takes any T."""
    args = _mlstm_inputs(card, 2, 3 * ml.CHUNK + 17, 2, 64, seed=1)
    out = ml.mlstm_chunkwise(*args)
    assert _mlstm_rel(out, mlstm_chunkwise_ref(*args)) < MLSTM_TOL["float32"]


def test_mlstm_kernel_reads_strided_inputs(card):
    """q, k, v as head-major views of one (B, H, T, 3D) tensor and gates as
    views of a (B, H, T, 2) tensor: every axis but D strided, no copies."""
    B, T, H, D = 1, 192, 2, 64
    q, k, v, ig, fg = _mlstm_inputs(card, B, T, H, D, seed=2)
    qkv = torch.cat([q, k, v], dim=-1).transpose(1, 2).contiguous()  # (B, H, T, 3D)
    gates = torch.stack([ig, fg], dim=-1).transpose(1, 2).contiguous()  # (B, H, T, 2)
    views = [qkv[..., i * D:(i + 1) * D].transpose(1, 2) for i in range(3)]
    views += [gates[..., 0].transpose(1, 2), gates[..., 1].transpose(1, 2)]
    assert not any(t.is_contiguous() for t in views)
    out = ml.mlstm_chunkwise(*views)
    torch.testing.assert_close(out, ml.mlstm_chunkwise(q, k, v, ig, fg), atol=0, rtol=0)


def test_mlstm_auto_on_card_launches_the_kernel(card):
    args = _mlstm_inputs(card, 1, 128, 2, 64)
    before = ml.LAUNCHES
    out = ops.mlstm(*args, impl="auto")
    assert ml.LAUNCHES == before + 1
    assert _mlstm_rel(out, ops.mlstm(*args, impl="ref")) < MLSTM_TOL["float32"]
    assert ml.LAUNCHES == before + 1


def test_mlstm_kernel_rejects_what_it_does_not_take(card):
    q, k, v, ig, fg = _mlstm_inputs(card, 1, 64, 2, 32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ml.mlstm_chunkwise(q.cpu(), k, v, ig, fg)
    with pytest.raises(ValueError, match="i_gate lies on cpu"):  # mixed devices
        ml.mlstm_chunkwise(q, k, v, ig.cpu(), fg)
    with pytest.raises(ValueError, match=r"q must be \(B, T, H, D\)"):
        ml.mlstm_chunkwise(q[0], k[0], v[0], ig[0], fg[0])
    with pytest.raises(ValueError, match="k is"):
        ml.mlstm_chunkwise(q, k[:, :-1], v, ig, fg)
    with pytest.raises(ValueError, match="f_gate is"):
        ml.mlstm_chunkwise(q, k, v, ig, fg[..., :1])
    with pytest.raises(TypeError, match="float16"):
        ml.mlstm_chunkwise(q.half(), k.half(), v.half(), ig, fg)
    with pytest.raises(TypeError, match="gates must be float32"):
        ml.mlstm_chunkwise(q, k, v, ig.bfloat16(), fg)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        ml.mlstm_chunkwise(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, ig, fg)


# K3's wgmma route (bf16, D % 64 == 0, D <= 512): chunk 128, every fp32
# operand of a numerator product split into bf16 hi and lo


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[f"case{i}" for i in range(len(MLSTM_CASES))])
def test_mlstm_wgmma_route_matches_plain_version(card, case):
    """Every MLSTM_CASES shape in bf16 runs the wgmma route, within the bf16
    bar of the plain version at the route's chunk (or T, where shorter)."""
    B, T, H, D, _ = case
    args = _mlstm_inputs(card, B, T, H, D, "bfloat16", seed=3)
    p = ml.plan(*args[:3])
    assert p.route == "wgmma" and p.chunk == ml.WGMMA_CHUNK
    out = ml.mlstm_chunkwise(*args)
    ref = mlstm_chunked_scan(*args, chunk=min(p.chunk, T))
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    assert bool(torch.isfinite(out).all())
    assert _mlstm_rel(out, ref) < MLSTM_TOL["bfloat16"]


@pytest.mark.parametrize("T", [100, 3 * ml.WGMMA_CHUNK + 17])
def test_mlstm_wgmma_route_masks_ragged_T(card, T):
    """bf16, T no multiple of the route's chunk (and shorter than one chunk):
    the short last chunk is masked; the quadratic oracle takes any T."""
    args = _mlstm_inputs(card, 2, T, 2, 64, "bfloat16", seed=4)
    assert ml.plan(*args[:3]).route == "wgmma"
    out = ml.mlstm_chunkwise(*args)
    assert _mlstm_rel(out, mlstm_chunkwise_ref(*args)) < MLSTM_TOL["bfloat16"]


def test_mlstm_wgmma_route_reads_strided_inputs(card):
    """bf16 q, k, v as head-major views of one (B, H, T, 3D) tensor and gates as
    views of a (B, H, T, 2) tensor, through the TMA maps: bit-equal to the
    contiguous inputs."""
    B, T, H, D = 2, 320, 2, 128
    q, k, v, ig, fg = _mlstm_inputs(card, B, T, H, D, "bfloat16", seed=5)
    qkv = torch.cat([q, k, v], dim=-1).transpose(1, 2).contiguous()  # (B, H, T, 3D)
    gates = torch.stack([ig, fg], dim=-1).transpose(1, 2).contiguous()  # (B, H, T, 2)
    views = [qkv[..., i * D:(i + 1) * D].transpose(1, 2) for i in range(3)]
    views += [gates[..., 0].transpose(1, 2), gates[..., 1].transpose(1, 2)]
    assert not any(t.is_contiguous() for t in views)
    assert ml.plan(*views[:3]).route == "wgmma"
    out = ml.mlstm_chunkwise(*views)
    torch.testing.assert_close(out, ml.mlstm_chunkwise(q, k, v, ig, fg), atol=0, rtol=0)


@pytest.mark.parametrize("D", [32, 96])
def test_mlstm_bf16_head_dims_off_64_take_the_cuda_core_route(card, D):
    args = _mlstm_inputs(card, 1, 192, 2, D, "bfloat16", seed=6)
    p = ml.plan(*args[:3])
    assert p.route == "cuda_cores" and p.chunk == ml.CHUNK
    before = ml.LAUNCHES
    out = ml.mlstm_chunkwise(*args)
    assert ml.LAUNCHES == before + 1
    assert _mlstm_rel(out, mlstm_chunked_scan(*args, chunk=ml.CHUNK)) < MLSTM_TOL["bfloat16"]


def test_mlstm_wgmma_plan_matches_the_kernels_shared_memory(card):
    lib = ml._library()
    for D in (64, 192, 512):
        q = torch.zeros(1, 256, 1, D, dtype=torch.bfloat16, device=card)
        smem = dict(ml.plan(q, q, q).smem)
        assert smem == {"states": lib.ml_wgmma_smem_bytes(D, 0), "output": lib.ml_wgmma_smem_bytes(D, 1)}
        assert max(smem.values()) <= ml.SMEM_LIMIT


def test_mlstm_wgmma_split_beats_plain_bf16_operands(card):
    """The precision control: the route's arithmetic with W, the key-weighted
    k and C rounded to bf16 once (the plain-torch model, in fp32 on the CPU)
    fails the bf16 bar where the kernel's split operands hold it."""
    args = _mlstm_inputs(card, 1, 512, 2, 128, "bfloat16", seed=0)
    ref = mlstm_chunked_scan(*args, chunk=ml.WGMMA_CHUNK)
    split = _mlstm_rel(ml.mlstm_chunkwise(*args), ref)
    plain = _mlstm_rel(mlstm_rounded_scan(*(a.cpu() for a in args), operands="bf16"), ref.cpu())
    assert split < MLSTM_TOL["bfloat16"] < plain


@pytest.mark.parametrize("T", [3 * ml.WGMMA_CHUNK, 2 * ml.WGMMA_CHUNK + 45])
@pytest.mark.parametrize("D", [192, 256])
def test_mlstm_wgmma_route_covers_every_tile_layout(card, D, T):
    """bf16 at D 192, where the last 128-column tile of C and of the output
    lies half past D (TMA zero-fills and clips at a non-zero origin, the n
    store's guard is live), and at D 256 (whole tiles), T whole or ragged:
    against the chunked scan at the route's chunk on the inputs zero-padded to
    whole chunks (causal: the padding changes no earlier step)."""
    args = _mlstm_inputs(card, 2, T, 2, D, "bfloat16", seed=7)
    p = ml.plan(*args[:3])
    assert p.route == "wgmma"
    out = ml.mlstm_chunkwise(*args)
    pad = -(-T // p.chunk) * p.chunk - T
    padded = [torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in args]
    ref = mlstm_chunked_scan(*padded, chunk=p.chunk)[:, :T]
    torch.cuda.synchronize()
    assert out.shape == args[0].shape and bool(torch.isfinite(out).all())
    assert _mlstm_rel(out, ref) < MLSTM_TOL["bfloat16"]


def test_mlstm_wgmma_route_refuses_what_tma_cannot_load(card):
    q, k, v, ig, fg = _mlstm_inputs(card, 1, 128, 2, 64, "bfloat16")
    flat = torch.zeros(1 + 128 * 2 * 64, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ml.mlstm_chunkwise(flat[1:].view(1, 128, 2, 64), k, v, ig, fg)
    wide = torch.zeros(1, 128, 2, 68, dtype=torch.bfloat16, device=card)[..., :64]  # rows of 136 bytes
    with pytest.raises(ValueError, match="stride"):
        ml.mlstm_chunkwise(q, wide, v, ig, fg)


# tests/test_kernels.py gmm cases as (group sizes, K, N), with every group one
# row block: the three even ones, the uneven one; then granite's decode shape
# (40 experts of one row, K 1536 -> N 512), an uneven ragged case (K and N
# multiples of 8 but not of a tile; row blocks of 200 rows, cut 128 + 72) and
# one with rows of 3 per expert
GMM_CASES = [
    ([256] * 4, 256, 128),
    ([128] * 8, 512, 256),
    ([128] * 2, 128, 128),
    ([256, 128, 384], 256, 128),
    ([1] * 40, 1536, 512),
    ([200] * 3, 200, 72),
    ([3] * 5, 40, 24),
]
# fp32 sums in another order: the bar of tests/test_kernels.py; a bf16 output
# may round the other way: one bf16 ulp (2^-8) and some
GMM_TOL = {"float32": 1e-3, "bfloat16": 1e-2}


def _gmm_inputs(card, sizes, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    lhs = torch.from_numpy(rng.standard_normal((sum(sizes), K)).astype(np.float32)).to(card, dt)
    rhs = torch.from_numpy(rng.standard_normal((len(sizes), K, N)).astype(np.float32)).to(card, dt)
    return lhs, rhs


def _row_blocks(card, sizes):
    """Group ids of equal row blocks: the greatest common size, each group cut into it."""
    bm = int(np.gcd.reduce(sizes))
    return torch.tensor(np.repeat(np.arange(len(sizes)), np.asarray(sizes) // bm), dtype=torch.int32,
                        device=card)


@pytest.mark.parametrize("out_dtype", [None, "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES, ids=[f"case{i}" for i in range(len(GMM_CASES))])
def test_gmm_kernel_matches_plain_version(card, case, dtype, out_dtype):
    sizes, K, N = case
    lhs, rhs = _gmm_inputs(card, sizes, K, N, dtype)
    want = lhs.dtype if out_dtype is None else getattr(torch, out_dtype)
    out = gk.gmm(lhs, rhs, _row_blocks(card, sizes), out_dtype=want)
    ref = gmm_ref(lhs, rhs, sizes, out_dtype=want)
    torch.cuda.synchronize()
    assert out.dtype == want and out.shape == (sum(sizes), N)
    tol = GMM_TOL["bfloat16" if want == torch.bfloat16 else "float32"]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("sizes", [[5] * 3, [40] * 2], ids=["small_tile", "large_tile"])
def test_gmm_kernel_fp32_takes_any_K_and_N(card, sizes):
    lhs, rhs = _gmm_inputs(card, sizes, 37, 19, "float32", seed=5)
    out = gk.gmm(lhs, rhs, _row_blocks(card, sizes))
    torch.testing.assert_close(out, gmm_ref(lhs, rhs, sizes), atol=1e-3, rtol=1e-3)


def test_gmm_kernel_reads_each_row_block_group(card):
    """Row blocks of one group need not be adjacent, nor groups in order."""
    lhs, rhs = _gmm_inputs(card, [64] * 4, 64, 64, "bfloat16", seed=1)
    ids = torch.tensor([2, 0, 2, 1], dtype=torch.int32, device=card)
    out = gk.gmm(lhs, rhs, ids, out_dtype=torch.float32)
    for i, g in enumerate(ids.tolist()):
        rows = slice(64 * i, 64 * (i + 1))
        torch.testing.assert_close(out[rows], lhs[rows].float() @ rhs[g].float(), atol=1e-3, rtol=1e-3)


def test_gmm_kernel_poisons_rows_of_a_bad_group_id(card):
    lhs, rhs = _gmm_inputs(card, [32] * 2, 64, 64, "float32", seed=2)
    out = gk.gmm(lhs, rhs, torch.tensor([0, 5], dtype=torch.int32, device=card))
    assert bool(torch.isfinite(out[:32]).all()) and bool(torch.isnan(out[32:]).all())


# the wgmma route (bf16, row blocks of more than 16 rows) at the paths' prefill
# shapes as (groups, rows per group, K, N): granite's up/gate and down, jamba's
# up/gate and down; then a persistent-schedule case, 50 x 3 x 3 = 450 tiles of
# 128 x 256, 3.4 waves of 132 SMs, with K and N multiples of no tile; then
# mixtral-8x7b's up/gate and down at its prefill (B 1 x S 8192, top-2 of 8
# experts: 2,560 rows an expert; N 14,336 is 56 column tiles of 256)
WGMMA_SHAPES = [
    (40, 1024, 1536, 512),
    (40, 1024, 512, 1536),
    (16, 640, 4096, 14336),
    (16, 640, 14336, 4096),
    (50, 384, 136, 520),
    (8, 2560, 4096, 14336),
    (8, 2560, 14336, 4096),
]


def _card_gmm_inputs(card, G, C, K, N, seed):
    """lhs ~ N(0, 1), rhs ~ N(0, 1/K) as the MoE's weights, drawn on the card
    (jamba's weight stack is 0.94 G numbers)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    lhs = torch.randn((G * C, K), generator=gen, device=card).bfloat16()
    rhs = (torch.randn((G, K, N), generator=gen, device=card) / K**0.5).bfloat16()
    return lhs, rhs


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=["granite_up", "granite_down", "jamba_up", "jamba_down",
                                                    "persistent", "mixtral_up", "mixtral_down"])
def test_gmm_wgmma_route_matches_plain_version(card, shape, out_dtype):
    G, C, K, N = shape
    lhs, rhs = _card_gmm_inputs(card, G, C, K, N, seed=G + K)
    ids = torch.arange(G, dtype=torch.int32, device=card)
    assert gk.plan(lhs, rhs, ids).route == "wgmma"
    want = getattr(torch, out_dtype)
    out = gk.gmm(lhs, rhs, ids, out_dtype=want)
    ref = gmm_ref(lhs, rhs, [C] * G, out_dtype=want)
    torch.cuda.synchronize()
    assert out.dtype == want
    torch.testing.assert_close(out.float(), ref.float(), atol=GMM_TOL[out_dtype], rtol=GMM_TOL[out_dtype])


def test_gmm_wgmma_route_stores_only_its_row_block(card):
    """Row blocks of 200 rows: each block's second tile (72 rows) reads the
    next block's rows through TMA, multiplies them by its own group's matrix,
    and stores only its own. Groups out of order, K and N multiples of no tile."""
    lhs, rhs = _gmm_inputs(card, [200] * 3, 200, 72, "bfloat16", seed=6)
    ids = torch.tensor([2, 0, 1], dtype=torch.int32, device=card)
    assert gk.plan(lhs, rhs, ids).route == "wgmma"
    out = gk.gmm(lhs, rhs, ids, out_dtype=torch.float32)
    for i, g in enumerate(ids.tolist()):
        rows = slice(200 * i, 200 * (i + 1))
        torch.testing.assert_close(out[rows], lhs[rows].float() @ rhs[g].float(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("block_m", [128, 200])
def test_gmm_wgmma_route_poisons_rows_of_a_bad_group_id(card, block_m):
    """The wgmma route: a bad id's rows come out NaN, its neighbours' stay right."""
    lhs, rhs = _gmm_inputs(card, [block_m] * 3, 128, 128, "bfloat16", seed=7)
    ids = torch.tensor([0, 7, 1], dtype=torch.int32, device=card)
    assert gk.plan(lhs, rhs, ids).route == "wgmma"
    out = gk.gmm(lhs, rhs, ids)
    bad = slice(block_m, 2 * block_m)
    assert bool(torch.isnan(out[bad]).all())
    for i, g in ((0, 0), (2, 1)):
        rows = slice(block_m * i, block_m * (i + 1))
        torch.testing.assert_close(out[rows].float(), (lhs[rows].float() @ rhs[g].float()).bfloat16().float(),
                                   atol=1e-2, rtol=1e-2)


def test_gmm_decode_takes_the_small_tile(card):
    """One row an expert (every decode step) stays on the mma.sync tile."""
    lhs, rhs = _gmm_inputs(card, [1] * 40, 1536, 512, "bfloat16", seed=8)
    ids = torch.arange(40, dtype=torch.int32, device=card)
    assert gk.plan(lhs, rhs, ids).route == "mma_sync"
    torch.testing.assert_close(gk.gmm(lhs, rhs, ids).float(), gmm_ref(lhs, rhs, [1] * 40).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape", [(8, 2, 4096, 14336), (8, 2, 14336, 4096)], ids=["up", "down"])
def test_gmm_mixtral_decode_takes_the_small_tile(card, shape):
    """mixtral-8x7b's decode at batch 4 (top-2 of 8: 2 rows an expert)."""
    G, C, K, N = shape
    lhs, rhs = _card_gmm_inputs(card, G, C, K, N, seed=K)
    ids = torch.arange(G, dtype=torch.int32, device=card)
    assert gk.plan(lhs, rhs, ids).route == "mma_sync"
    for out_dtype in (torch.bfloat16, torch.float32):
        tol = GMM_TOL[str(out_dtype).removeprefix("torch.")]
        torch.testing.assert_close(gk.gmm(lhs, rhs, ids, out_dtype=out_dtype).float(),
                                   gmm_ref(lhs, rhs, [C] * G, out_dtype=out_dtype).float(), atol=tol, rtol=tol)


def test_gmm_auto_on_card_launches_the_kernel(card):
    lhs, rhs = _gmm_inputs(card, [64] * 2, 64, 32, "float32", seed=3)
    ids = torch.arange(2, dtype=torch.int32, device=card)
    before = gk.LAUNCHES
    out = ops.gmm(lhs, rhs, ids, [64, 64], impl="auto")
    assert gk.LAUNCHES == before + 1
    torch.testing.assert_close(out, ops.gmm(lhs, rhs, ids, [64, 64], impl="ref"), atol=1e-3, rtol=1e-3)
    assert gk.LAUNCHES == before + 1


def test_gmm_kernel_rejects_what_it_does_not_take(card):
    lhs, rhs = _gmm_inputs(card, [64] * 2, 64, 32, "bfloat16", seed=4)
    ids = torch.arange(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        gk.gmm(lhs.cpu(), rhs, ids)
    with pytest.raises(ValueError, match="group_ids lies on cpu"):
        gk.gmm(lhs, rhs, ids.cpu())
    with pytest.raises(TypeError, match="float16"):
        gk.gmm(lhs.half(), rhs.half(), ids)
    with pytest.raises(TypeError, match="for both"):
        gk.gmm(lhs, rhs.float(), ids)
    with pytest.raises(TypeError, match="out_dtype"):
        gk.gmm(lhs.float(), rhs.float(), ids, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        gk.gmm(lhs, rhs, ids.long())
    with pytest.raises(ValueError, match="must be contiguous"):
        gk.gmm(lhs, rhs.transpose(1, 2).contiguous().transpose(1, 2), ids)
    with pytest.raises(ValueError, match="equal row blocks"):
        gk.gmm(lhs, rhs, torch.arange(3, dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="K="):
        gk.gmm(lhs[:, :48].contiguous(), rhs, ids)
    with pytest.raises(ValueError, match="multiples of 8"):
        gk.gmm(lhs[:, :60].contiguous(), rhs[:, :60].contiguous(), ids)
    with pytest.raises(ValueError, match="16-byte boundary"):
        buf = torch.empty(128 * 64 + 8, dtype=torch.bfloat16, device=card)
        gk.gmm(buf[4:4 + 128 * 64].view(128, 64), rhs, ids)  # contiguous, 8 bytes off


# ----------------------- the batched MIG simulator -----------------------
# simulate_batch (repro_torch.core.batched) on the card against the port's CPU
# run of the same inputs; the bars of tests/test_torch_sim.py: integers exact,
# energy and busy within 1e-5 relative, the tardiness integral within 1e-4
# relative or 1e-3 absolute, minutes within 1e-3 absolute


def _sim_row(scenario, policy, seeds, load=0.2):
    import repro_torch.core.batched as P
    from repro_torch.core.scenarios import generate_scenario
    from repro_torch.core.simulator import DayNightPolicy, StaticPolicy

    tables = P.build_tables()
    lists = [generate_scenario(scenario, seed=s, load_scale=load) for s in seeds]
    jobs = P.BatchedJobs.from_job_lists(lists, max_slots=tables.max_slots)
    pol = {"static": lambda: StaticPolicy(3), "daynight": DayNightPolicy}[policy]()
    return tables, jobs, P.compile_policy(pol, tables, len(lists))


def _assert_sim_close(card_res, cpu_res):
    for f in ("repartitions", "preemptions", "num_jobs"):
        assert np.array_equal(getattr(card_res, f), getattr(cpu_res, f)), f
    done = np.isfinite(cpu_res.completion)
    assert np.array_equal(np.isfinite(card_res.completion), done)
    np.testing.assert_allclose(card_res.completion[done], cpu_res.completion[done], rtol=0, atol=1e-3)
    np.testing.assert_allclose(card_res.makespan_min, cpu_res.makespan_min, rtol=0, atol=1e-3)
    np.testing.assert_allclose(card_res.energy_wh, cpu_res.energy_wh, rtol=1e-5)
    np.testing.assert_allclose(card_res.busy_slot_minutes, cpu_res.busy_slot_minutes, rtol=1e-5)
    np.testing.assert_allclose(card_res.tardiness_integral, cpu_res.tardiness_integral, rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(card_res.util_histogram, cpu_res.util_histogram, rtol=0, atol=1e-3)


def test_simulate_batch_on_the_card_matches_the_cpu(card):
    import repro_torch.core.batched as P

    tables, jobs, pol = _sim_row("paper-diurnal", "daynight", range(6))
    res = P.simulate_batch(jobs, pol, tables=tables)  # device=None: the card
    _assert_sim_close(res, P.simulate_batch(jobs, pol, tables=tables, device="cpu"))


def test_simulate_batch_past_the_last_block_and_into_the_sentinel(card):
    """Rollout 0 has 3 jobs in one 32-job block, so 11 of the EDF search's 14
    ranks run past the last block; rollout 1 queues 40 short jobs on seven
    1-slot slices, so freed slices are handed on while every lane without a
    handoff writes the sentinel column. An index out of range would be a
    device-side assert at the synchronize."""
    import repro_torch.core.batched as P
    from repro_torch.core.jobs import LINEAR, Job, JobKind, capped
    from repro_torch.core.simulator import StaticPolicy

    few = [Job(i, JobKind.TRAINING, 0.1 * i, 30.0, 60.0 + i, LINEAR) for i in range(3)]
    queue = [Job(i, JobKind.INFERENCE, 0.1 * i, 1.0 + 0.37 * (i % 5), 0.1 * i + 5.0 + i % 7,
                 capped(2) if i % 2 else LINEAR) for i in range(40)]
    tables = P.build_tables()
    jobs = P.BatchedJobs.from_job_lists([few, queue], max_slots=tables.max_slots)
    assert jobs.padded_jobs == 64
    pol = P.compile_policy(StaticPolicy(12), tables, 2)
    res = P.simulate_batch(jobs, pol, tables=tables)
    torch.cuda.synchronize()
    assert np.isfinite(res.completion[jobs.valid]).all()
    _assert_sim_close(res, P.simulate_batch(jobs, pol, tables=tables, device="cpu"))


def test_simulate_batch_repeats_bitwise_on_the_card(card):
    import repro_torch.core.batched as P

    tables, jobs, pol = _sim_row("bursty-mmpp", "static", range(4))
    a = P.simulate_batch(jobs, pol, tables=tables, repartition_mode="drain")
    b = P.simulate_batch(jobs, pol, tables=tables, repartition_mode="drain")
    for f in ("repartitions", "preemptions", "num_jobs"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(np.isfinite(a.completion), np.isfinite(b.completion))


# ------------------------- the on-device DQN trainer -----------------------
# repro_torch.core.rl on the card against the port's CPU run of the same
# inputs: the TD update within DESIGN.md §11's 1e-5, the round of
# tests/data/torch_rl_golden.json (the reference's draws replayed) with every
# integer exact, and the checked-in baseline's params probe.

BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"


def test_rl_round_on_the_card_matches_the_cpu_and_the_golden_file(card):
    import json

    from torch_rl_golden import GOLDEN, golden_draws, port_round

    g = json.loads(GOLDEN.read_text())["round"]
    got = port_round(golden_draws(g, "cuda"), g["config"], "cuda")
    cpu = port_round(golden_draws(g, "cpu"), g["config"], "cpu")
    for k in ("pos", "size", "gstep", "updates"):
        assert got[k] == cpu[k] == g[k], k
    for k in ("live", "action", "cfg"):
        assert np.array_equal(got[k], cpu[k]), k
    assert np.array_equal(got["replay"]["a"], cpu["replay"]["a"])
    assert got["live"].astype(int).ravel().tolist() == g["live"]
    assert got["replay"]["a"].tolist() == g["replay_a"] and got["cfg"].tolist() == g["cfg"]
    assert np.abs(got["reward"].ravel() - np.asarray(g["reward"])).max() <= 1e-6
    assert np.abs(got["replay"]["r"] - np.asarray(g["replay_r"])).max() <= 1e-6
    ran = ~np.isnan(cpu["loss"])
    assert np.abs(got["loss"][ran] - cpu["loss"][ran]).max() <= 1e-5
    for (cw, cb), (pw, pb) in zip(got["params"], cpu["params"]):
        assert np.abs(cw - pw).max() <= 1e-5 and np.abs(cb - pb).max() <= 1e-5


def test_rl_td_update_on_the_card_matches_the_cpu(card):
    from torch_rl_golden import port_td_update

    (card_loss, card_params), (cpu_loss, cpu_params) = port_td_update("cuda"), port_td_update("cpu")
    assert abs(card_loss - cpu_loss) <= 1e-5
    for (cw, cb), (pw, pb) in zip(card_params, cpu_params):
        assert np.abs(cw - pw).max() <= 1e-5 and np.abs(cb - pb).max() <= 1e-5


def test_rl_params_probe_on_the_card(card):
    import json

    from repro_torch.core.rl import dqn as PD

    probe = json.loads((BASELINES / "rl_batched.json").read_text())["params_probe"]
    learner = PD.DQNLearner(PD.DQNConfig(state_dim=18))  # device=None: the card
    learner.load(str(BASELINES / "rl_dqn_params.npz"))
    assert learner.device.type == "cuda"
    obs = np.random.default_rng(probe["seed"]).uniform(0.0, 1.0, size=(len(probe["actions"]), 18))
    assert [learner.greedy_action(o.astype(np.float32)) for o in obs] == probe["actions"]


def test_rl_argmax_on_the_card_takes_the_first_of_tied_maxima(card):
    q = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0], [0.0, 1.0, 0.0, 1.0]],
                     device="cuda")
    assert q.argmax(1).tolist() == [1, 0, 1]
    wide = torch.zeros((64, 12), device="cuda")
    wide[:, 5] = wide[:, 9] = 1.0
    assert (wide.argmax(1) == 5).all()


# ------------------------------ the MoE combine ------------------------------
# granite-moe-3b-a800m's MoE layer at full width in bf16, twice on one input:
# the combine sums each token's 8 expert copies, each rounded to bf16, so an
# order that changed from run to run would show in the bits


def test_moe_layer_gives_the_same_bits_twice(card):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply, moe_init

    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"), dtype="bfloat16",
                              param_dtype="bfloat16")
    gen = torch.Generator(device=card).manual_seed(0)
    p = moe_init(gen, cfg, torch.bfloat16, card)
    x = torch.randn((2, 2048, cfg.d_model), generator=gen, device=card).to(torch.bfloat16)
    with torch.inference_mode():
        a, aux_a = moe_apply(p, cfg, x)
        b, aux_b = moe_apply(p, cfg, x)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(aux_a, aux_b)


# ------------------------------ the evaluator -------------------------------
# repro_torch.launch.evaluate with the greedy Q network on the card against
# the port's CPU run and the checked-in race (benchmarks/baselines/rl_batched.json)


def test_eval_greedy_actions_on_the_card_equal_the_cpus(card):
    import json

    from repro_torch.core.rl.agent import greedy_policy
    from repro_torch.core.rl.train import evaluate_policy
    from repro_torch.launch import evaluate as PE

    params = str(BASELINES / "rl_dqn_params.npz")
    probe = json.loads((BASELINES / "rl_batched.json").read_text())["params_probe"]
    learner = PE.load_learner(params)  # device=None: the card
    assert learner.device.type == "cuda"
    assert PE.params_probe(learner) == probe
    log = PE.DecisionLog(learner)
    evaluate_policy(lambda: greedy_policy(log, decision_interval_min=15.0), num_iterations=1,
                    seed=PE.EVAL_SEED, scenario="paper-diurnal")
    assert len(log.records) >= 96
    assert PE.action_flips(log, PE.load_learner(params, "cpu")) == []


def test_eval_race_row_on_the_card_equals_the_checked_in_one(card):
    import json

    from repro_torch.launch import evaluate as PE

    want = json.loads((BASELINES / "rl_batched.json").read_text())["rows"][0]
    rows, _ = PE.race(PE.load_learner(str(BASELINES / "rl_dqn_params.npz")), 0.1,
                      families=(want["scenario"],))
    assert rows[0] == {**want, "et_a": rows[0]["et_a"]}
    assert abs(rows[0]["et_a"] - want["et_a"]) <= 1e-9 * abs(want["et_a"])


def test_eval_entry_points_raise_when_no_card_is_present(card, monkeypatch):
    from repro_torch.core.rl.train import evaluate_policy
    from repro_torch.launch import evaluate as PE
    from repro_torch.sweep.cells import make_cell, run_cell

    cell = make_cell(experiment="x", group="x", scheduler="EDF-SS", seed=0,
                     scenario="weekend-flat", policy="static")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: evaluate_policy("static", num_iterations=1),
                 lambda: run_cell(cell),
                 lambda: PE.main(["--table3", "--scale", "0.1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------ the trainer ---------------------------------
# repro_torch.distributed.make_train_step (loss_fn through autograd on the
# plain versions, impl="ref", as the reference trains) on the card against
# the CPU, the checkpoint store with card tensors, and two identical bf16
# steps of gemma3-1b's smoke config; chip_smoke.py's train_parity and train
# phases hold every arch and the full-width run


def _train_setup(arch, dtype, accum=1):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig, linear_warmup_cosine

    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype, param_dtype=dtype, remat="block")
    opt = AdamW(AdamWConfig(lr=linear_warmup_cosine(1e-3, 1, 4)))
    step = make_train_step(cfg, opt, accum_steps=accum, impl="ref")
    return cfg, opt, step, SyntheticLM(cfg, 4, 64, seed=0)


def _to(tree_or_state, device):
    from repro_torch.optim import OptState
    from repro_torch.tree import leaves, unflatten

    if isinstance(tree_or_state, OptState):
        return OptState(m=[t.to(device) for t in tree_or_state.m],
                        v=[t.to(device) for t in tree_or_state.v],
                        step=tree_or_state.step.to(device))
    return unflatten(tree_or_state, [t.to(device) for t in leaves(tree_or_state)])


@pytest.mark.parametrize("arch, accum", [("gemma3_1b", 1), ("granite_moe_3b_a800m", 2)])
def test_train_step_on_the_card_matches_the_cpu(card, arch, accum):
    from repro_torch.models import init_params
    from repro_torch.tree import leaves

    cfg, opt, step, data = _train_setup(arch, "float32", accum)
    params = init_params(cfg, seed=0, device="cpu")
    p1, s1, _ = step(params, opt.init(leaves(params)), data.batch_for_step(0))
    p_cpu, s_cpu, m_cpu = step(p1, s1, data.batch_for_step(1))
    p_card, s_card, m_card = step(_to(p1, card), _to(s1, card), data.batch_for_step(1))
    assert m_card["loss"].is_cuda and p_card["embed"].is_cuda
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= 1e-5 * abs(float(m_cpu[k])), k
    assert int(m_card["step"]) == 2
    for a, b in zip(leaves(p_card), leaves(p_cpu), strict=True):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-30)
    for a, b in zip(s_card.m + s_card.v, s_cpu.m + s_cpu.v, strict=True):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


def test_train_checkpoint_round_trip_of_card_tensors(card, tmp_path):
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
    from repro_torch.tree import leaves

    gen = torch.Generator(device=card).manual_seed(0)
    tree = {"w": torch.randn((64, 32), generator=gen, device=card).to(torch.bfloat16),
            "opt": [torch.randn((7,), generator=gen, device=card), torch.tensor(3, device=card,
                                                                               dtype=torch.int32)]}
    save_checkpoint(str(tmp_path), 1, tree)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, tree)
    tree["w"].zero_()  # the snapshot was taken before save_async returned
    mgr.wait()
    want = [torch.randn((64, 32), generator=torch.Generator(device=card).manual_seed(0),
                        device=card).to(torch.bfloat16)]
    for step in (1, 2):
        out = restore_checkpoint(str(tmp_path), step, tree)  # device=None: the card
        assert all(t.is_cuda for t in leaves(out))
        assert torch.equal(out["w"].view(torch.int16), want[0].view(torch.int16))
        assert torch.equal(out["opt"][0], tree["opt"][0]) and int(out["opt"][1]) == 3
    cpu = restore_checkpoint(str(tmp_path), 2, tree, device="cpu")
    assert cpu["w"].device.type == "cpu" and torch.equal(cpu["w"], want[0].cpu())


def test_train_bf16_step_gives_the_same_bits_twice(card):
    """Two identical bf16 steps of gemma3-1b's smoke config: the same loss,
    gradient norm, parameters and moments, bit for bit."""
    from repro_torch.models import init_params
    from repro_torch.tree import leaves

    cfg, opt, step, data = _train_setup("gemma3_1b", "bfloat16")
    params = init_params(cfg, seed=0, device=card)
    state = opt.init(leaves(params))
    batch = data.batch_for_step(0)
    a = step(params, state, batch)
    b = step(params, state, batch)
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    assert torch.equal(a[2]["grad_norm"], b[2]["grad_norm"])
    for x, y in zip(leaves(a[0]) + a[1].m + a[1].v, leaves(b[0]) + b[1].m + b[1].v, strict=True):
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


# -------------------------- the encoder-decoder ------------------------------


def test_whisper_decode_with_enc_out_on_the_card_matches_the_cpu(card):
    """whisper-base's smoke config in fp32, with one head of 64 (the kernel
    takes head dims from 64; the smoke config's two heads are of 32): the
    encoder's output and 8 decode steps with it (K1 at Sq = 1 in every
    cross-attention) on the card, against the same on the CPU (plain
    attention), at the fp32 logits bar."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import decode_step, encode, init_cache, init_params
    from repro_torch.tree import leaves, unflatten

    cfg = dataclasses.replace(smoke_config("whisper_base"), n_heads=1, n_kv_heads=1, dtype="float32",
                              param_dtype="float32")
    assert cfg.resolved_head_dim == 64
    params = init_params(cfg, seed=0, device="cpu")
    on_card = unflatten(params, [t.to(card) for t in leaves(params)])
    rng = np.random.default_rng(10)
    frames = rng.standard_normal((2, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    enc_cpu = encode(cfg, params, frames, device="cpu")
    enc_card = encode(cfg, on_card, torch.from_numpy(frames).to(card))
    assert enc_card.is_cuda
    torch.testing.assert_close(enc_card.cpu(), enc_cpu, atol=1e-5, rtol=1e-5)
    cache_cpu, cache_card = init_cache(cfg, 2, 8, device="cpu"), init_cache(cfg, 2, 8)
    before = fa.LAUNCHES
    for i in range(8):
        tok = tokens[:, i : i + 1]
        want, cache_cpu = decode_step(cfg, params, cache_cpu, tok, i, enc_out=enc_cpu, device="cpu")
        got, cache_card = decode_step(cfg, on_card, cache_card, torch.from_numpy(tok).to(card), i,
                                      enc_out=enc_card)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale, i
    assert fa.LAUNCHES == before + 8 * cfg.n_layers


# ----------------------- the logits product and nemotron ----------------------


@pytest.mark.parametrize("d_model", [1152, 2048, 4100, 18432])
def test_logits_product_on_the_card_matches_the_upcast(card, d_model):
    """bf16 operands with autograd off: fp32 logits within 1e-5 of max of
    the fp32 upcast's (one chunk of d_model, exactly one, one and a ragged
    4-column one, nemotron's nine); while autograd records, the upcast itself."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config("nemotron_4_340b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    gen = torch.Generator(device=card).manual_seed(d_model)
    x = torch.randn(3, 40, d_model, device=card, generator=gen).bfloat16()
    u = torch.randn(1000, d_model, device=card, generator=gen).bfloat16()
    params = {"unembed": u}
    want = torch.matmul(x.float(), u.float().t())
    with torch.inference_mode():
        got = T._logits(cfg, params, x)
    assert got.dtype == torch.float32 and got.shape == (3, 40, 1000)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    recorded = T._logits(cfg, params, x.clone().requires_grad_())
    assert recorded.requires_grad and torch.equal(recorded.detach(), want)


def test_logits_product_on_the_card_makes_no_fp32_copy_of_the_unembedding(card):
    """32 rows against a 65,536 x 4,096 bf16 unembedding (0.54 GB; 1.07 GB in
    fp32): the product allocates its 8 MB of logits (the second chunk adds
    into them in place), not the copy; the upcast does allocate it."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(smoke_config("nemotron_4_340b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    x = torch.randn(1, 32, 4096, device=card).bfloat16()
    params = {"unembed": torch.randn(65536, 4096, device=card).bfloat16()}

    def extra_gb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    with torch.inference_mode():
        assert extra_gb(lambda: T._logits(cfg, params, x)) < 0.01
        assert extra_gb(lambda: torch.matmul(x.float(), params["unembed"].float().t())) > 1.0


def test_nemotron_smoke_on_the_card_matches_the_cpu(card):
    """nemotron-4-340b's smoke config in fp32 with heads of 64 (the kernel
    takes head dims from 64): forward on the card (K1 in each layer, GQA 2/1)
    against the CPU (plain attention) at the fp32 logits bar, then 8 decode
    steps; in bf16, the card's forward (K1 and the chunked logits product)
    gives finite fp32 logits (chip_smoke.py's nemotron_prefill holds its
    top-1 at full width)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.tree import leaves, unflatten

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke_config("nemotron_4_340b"), n_heads=2, n_kv_heads=1,
                                  dtype=dtype, param_dtype=dtype)
        assert cfg.resolved_head_dim == 64
        params = init_params(cfg, seed=0, device="cpu")
        on_card = unflatten(params, [t.to(card) for t in leaves(params)])
        tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 64))
        with torch.inference_mode():
            want, _ = forward(cfg, params, {"tokens": tokens}, device="cpu")
            before = fa.LAUNCHES
            got, _ = forward(cfg, on_card, {"tokens": torch.from_numpy(tokens).to(card)})
            assert fa.LAUNCHES == before + cfg.n_layers
        if dtype == "bfloat16":
            assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
            continue
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
        cache_cpu, cache_card = init_cache(cfg, 2, 8, device="cpu"), init_cache(cfg, 2, 8)
        for i in range(8):
            tok = tokens[:, i : i + 1]
            w, cache_cpu = decode_step(cfg, params, cache_cpu, tok, i, device="cpu")
            g, cache_card = decode_step(cfg, on_card, cache_card, torch.from_numpy(tok).to(card), i)
            assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max()), i


# ------------------------------ the serving day -------------------------------


def test_serving_day_on_the_card_machine_matches_the_golden_file(card):
    """The multi-tenant-serving day of tests/data/torch_serving_golden.json
    under EDF-FS through ``run_cell`` on the card's machine (host code; the
    card's default device resolves), against the reference's result."""
    import json

    from repro_torch.launch.evaluate import _exact_part, values_close
    from repro_torch.sweep.cells import make_scenario_cell, run_cell

    golden = json.loads((Path(__file__).resolve().parent / "data" / "torch_serving_golden.json")
                        .read_text())["EDF-FS"]
    cell = make_scenario_cell(
        experiment="t", group="g", scheduler="EDF-FS", seed=11, scenario="multi-tenant-serving",
        scenario_kwargs={"horizon_min": 1440.0, "load_scale": 1.0}, policy="static",
        policy_kwargs={"config_id": 3})
    assert cell == golden["cell"]
    got = run_cell(cell)
    got.pop("elapsed_s")
    want = golden["result"]
    assert values_close(got, want, 1e-9) and _exact_part(got) == _exact_part(want)
    assert {n: (t["jobs"], t["attained"]) for n, t in got["tenants"].items()} == {
        n: (t["jobs"], t["attained"]) for n, t in want["tenants"].items()}


# ------------------------- the host trainer and the fleet ---------------------
# repro_torch.core.rl.train.train_dqn (the paper's host loop) and the fleet
# layer's DQN evaluation with the Q networks on the card, against the port's
# CPU runs and tests/data/torch_fleet_golden.json


def _host_train_recording(log):
    from repro_torch.core.rl import train as PT

    class Recording(PT.DQNLearner):
        def act(self, state, epsilon):  # the base act's draws and choice, recorded
            if self._rng.uniform() < epsilon:
                a = int(self._rng.integers(0, self.cfg.num_actions))
                log.append((a, None))
                return a
            q = self.q(state)
            log.append((int(np.argmax(q)), q))
            return log[-1][0]

    return Recording


def test_host_train_td_updates_on_the_card_match_the_cpu(card):
    import dataclasses

    from repro_torch.core.rl import dqn as PD
    from repro_torch.launch import train_rl

    cfg = dataclasses.replace(train_rl.host_dqn_config(400), min_buffer=256)  # the example's learner
    rng = np.random.default_rng(0)
    n = 512
    s, s2 = rng.uniform(size=(2, n, cfg.state_dim)).astype(np.float32)
    a = rng.integers(0, cfg.num_actions, size=n)
    r = rng.normal(size=n).astype(np.float32)
    done = rng.uniform(size=n) < 0.05
    g = (cfg.gamma ** rng.integers(1, cfg.n_step + 1, size=n)).astype(np.float32)
    runs = []
    for dev in ("cuda", "cpu"):
        learner = PD.DQNLearner(cfg, device=dev)
        for i in range(n):
            learner.observe(s[i], a[i], r[i], s2[i], done[i], g[i])
        losses = [learner.maybe_train(1) for _ in range(4)]
        runs.append((losses, PD.mlp_params_to_numpy(learner.params), learner.device.type))
    (card_losses, card_params, t), (cpu_losses, cpu_params, _) = runs
    assert t == "cuda" and np.isfinite(card_losses).all()
    assert np.abs(np.asarray(card_losses) - np.asarray(cpu_losses)).max() <= 1e-5
    for (cw, cb), (pw, pb) in zip(card_params, cpu_params):
        assert np.abs(cw - pw).max() <= 1e-5 and np.abs(cb - pb).max() <= 1e-5


def test_host_train_episodes_on_the_card_match_the_cpu(card, monkeypatch):
    """Two episodes (one guided) of a 10-hour day with a small learner: the
    same actions, rewards and losses as the CPU up to the first greedy flip,
    which may only fall between Q values 1e-5 of their size apart."""
    from repro_torch.core.rl import dqn as PD
    from repro_torch.core.rl import train as PT
    from repro_torch.core.rl.env import FEATURE_DIM
    from repro_torch.core.workload import WorkloadSpec
    from repro_torch.launch.cluster_sim import queue_heuristic_policy

    cfg = PD.DQNConfig(state_dim=FEATURE_DIM, hidden=(64, 64), n_step=3, lr=3e-4, batch_size=32,
                       min_buffer=64, target_sync_every=25, eps_decay_episodes=2, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        log = []
        monkeypatch.setattr(PT, "DQNLearner", _host_train_recording(log))
        learner, stats = PT.train_dqn(num_episodes=2, spec=WorkloadSpec(horizon_min=600.0), dqn_config=cfg,
                                      seed=2, guide=queue_heuristic_policy(), guide_episodes=1, device=dev)
        out[dev] = (learner, stats, log)
    (cl, cs, clog), (pl, ps, plog) = out["cuda"], out["cpu"]
    assert cl.device.type == "cuda" and cl.updates > 0
    flip = next((i for i, (x, y) in enumerate(zip(clog, plog)) if x[0] != y[0]), None)
    if flip is not None:
        q = clog[flip][1]
        assert q is not None and plog[flip][1] is not None
        top = np.sort(q)
        assert top[-1] - top[-2] <= 1e-5 * max(np.abs(q).max(), 1.0), (flip, top[-2:])
        return
    assert cs.env_steps == ps.env_steps and cl.updates == pl.updates
    assert cs.episode_rewards == pytest.approx(ps.episode_rewards, rel=1e-9)
    assert cs.episode_et_proxy == pytest.approx(ps.episode_et_proxy, rel=1e-9)
    assert np.abs(np.asarray(cs.losses) - np.asarray(ps.losses)).max() <= 1e-5 * np.abs(ps.losses).max()
    for (cw, cb), (pw, pb) in zip(PD.mlp_params_to_numpy(cl.params), PD.mlp_params_to_numpy(pl.params)):
        assert np.abs(cw - pw).max() <= 1e-5 * np.abs(pw).max()
        assert np.abs(cb - pb).max() <= 1e-5 * max(np.abs(pb).max(), 1e-30)


def test_fleet_dqn_day_on_the_card_matches_the_golden_file(card):
    """The golden file's first day (2xA100+2xA30, state-aware, the registry's
    "dqn" on the checked-in npz, one Q network a device on the card) equals the
    reference's result; where it would not, every difference must trace to a
    greedy flip between Q values 1e-5 of their size apart."""
    import json

    from repro_torch.core.rl.agent import greedy_policy
    from repro_torch.core.rl.train import evaluate_policy_fleet
    from repro_torch.launch import evaluate as PE
    from repro_torch.sweep.cells import make_fleet_cell, run_cell

    golden = json.loads((Path(__file__).resolve().parent / "data" / "torch_fleet_golden.json").read_text())
    g = golden["run"]
    params = str(BASELINES.parents[1] / g["params"])
    cell = make_fleet_cell(experiment="evaluate_policy_fleet", group="dqn", profiles=g["profiles"],
                           dispatcher=g["dispatcher"], scheduler=g["scheduler"], scenario=g["scenario"],
                           seed=g["seed"], policy="dqn", policy_kwargs={"params_path": params})
    got = run_cell(cell)  # device=None: the card
    got.pop("elapsed_s")
    want = golden["results"][0]
    equal = (PE.values_close(got, want, 1e-9) and PE._exact_part(got) == PE._exact_part(want)
             and got["dispatch_counts"] == want["dispatch_counts"])
    log = PE.DecisionLog(PE.load_learner(params))
    evaluate_policy_fleet(lambda: greedy_policy(log), profiles=g["profiles"], dispatcher=g["dispatcher"],
                          num_iterations=1, scheduler_name=g["scheduler"], scenario=g["scenario"],
                          seed=g["seed"])
    flips = PE.action_flips(log, PE.load_learner(params, "cpu"))
    assert len(log.records) > 0
    if equal:
        assert flips == []
    else:
        assert flips and all(f["q_gap"] <= 1e-5 * max(np.abs(log.records[f["decision"]][2]).max(), 1.0)
                             for f in flips), flips


# ------------------------------ the pod's day ---------------------------------
# repro_torch.launch.cluster_sim: --policy dynamic's greedy DQN, its Q network
# on the card, on the simulated TPU pod; chip_smoke.py's cluster_day phase
# holds every run of tests/data/torch_service_golden.json


def test_cluster_dqn_pod_day_on_the_card_equals_the_cpus(card):
    """One pod day (seed 5, the golden file's first ``dynamic`` day) with the
    Q network on the card: the result equals the port's CPU run and the
    reference's, every greedy action equals a CPU learner's, and the Q
    network's device launches are counted (at least one a decision)."""
    import dataclasses
    import json
    import sys

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.rl import DQNConfig, DQNLearner, greedy_policy
    from repro_torch.core.rl.env import FEATURE_DIM
    from repro_torch.launch import evaluate as PE
    from repro_torch.launch.cluster_sim import day_policy_factory, run_days

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_service_golden as G

    params = str(BASELINES / "rl_dqn_params.npz")
    cpu = run_days(day_policy_factory("dynamic", params, "cpu"), iterations=1, seed=G.CLUSTER_SEED)
    entry = run_days(day_policy_factory("dynamic", params), iterations=1, seed=G.CLUSTER_SEED)
    learner = DQNLearner(DQNConfig(state_dim=FEATURE_DIM))  # device=None: the card
    learner.load(params)
    assert learner.device.type == "cuda"
    log = PE.DecisionLog(learner)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run_days(lambda: greedy_policy(log), iterations=1, seed=G.CLUSTER_SEED)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    cpu_learner = DQNLearner(DQNConfig(state_dim=FEATURE_DIM), device="cpu")
    cpu_learner.load(params)
    assert PE.action_flips(log, cpu_learner) == []
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in entry] == [
        dataclasses.asdict(r) for r in cpu]
    want = json.loads(G.GOLDEN.read_text())["cluster"]["dynamic"][0]
    assert G.off(G.as_dict(got[0]), want) == []
    assert len(log.records) > 0 and launches >= len(log.records)


def test_cluster_dqn_policy_raises_when_no_card_is_present(card, monkeypatch):
    from repro_torch.launch import cluster_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_sim.day_policy_factory("dynamic", str(BASELINES / "rl_dqn_params.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_sim.main(["--policy", "dynamic", "--iterations", "1"])
