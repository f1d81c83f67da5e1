"""The port's kernels' plain versions (repro_torch.kernels) against the JAX package's, on the CPU.

The JAX side runs its oracle and its Pallas kernel in interpret mode, as
tests/test_kernels.py does; the port's side runs its plain version, which is
what ``ops.attention`` and ``ops.mamba_scan`` pick for CPU tensors. The CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro.kernels.mlstm import mlstm_chunkwise as jax_mlstm_chunkwise
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.kernels.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro.models.attention import _decode_attention as jax_decode_attention
import repro_torch.kernels.decode_attention as da
import repro_torch.kernels.flash_attention as fa
import repro_torch.kernels.gmm as gk
import repro_torch.kernels.mamba_scan as ms
import repro_torch.kernels.mlstm as ml
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    attention_ref,
    decode_attention_ref,
    mamba_scan_ref,
    mlstm_chunked_scan,
    mlstm_chunkwise_ref,
    mlstm_rounded_scan,
)

# tests/test_kernels.py ATTN_CASES: B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset, dtype
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, 0, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, None, 0, "float32"),
    (1, 256, 256, 4, 1, 64, True, 128, None, 0, "float32"),
    (2, 128, 128, 4, 2, 64, False, None, 50.0, 0, "float32"),
    (1, 128, 384, 4, 2, 64, True, None, None, 256, "float32"),
    (1, 256, 256, 2, 2, 64, True, None, None, 0, "bfloat16"),
    (1, 128, 128, 4, 4, 256, True, 64, None, 0, "float32"),
]
# tests/test_kernels.py::test_flash_attention_block_shapes
BLOCK_CASE = (1, 512, 512, 2, 2, 64, True, None, None, 0, "float32")
BLOCK_SHAPES = [(64, 128), (128, 64), (256, 256)]
# the tolerances of tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _kw(case):
    causal, window, softcap, q_offset = case[6:10]
    return {"causal": causal, "window": window, "softcap": softcap, "q_offset": q_offset}


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ATTN_CASES, ids=[f"case{i}" for i in range(len(ATTN_CASES))])
def test_attention_ref_matches_jax(case):
    dtype = case[-1]
    arrays = _inputs(case)
    port = _f32(attention_ref(*_port(arrays, dtype), **_kw(case)))
    jref = _f32(jax_attention_ref(*_jax(arrays, dtype), **_kw(case)))
    jfa = _f32(jax_flash_attention(*_jax(arrays, dtype), **_kw(case), interpret=True))
    tol = TOL[dtype]
    np.testing.assert_allclose(port, jref, atol=tol, rtol=tol)
    np.testing.assert_allclose(port, jfa, atol=tol, rtol=tol)


@pytest.mark.parametrize("blocks", BLOCK_SHAPES, ids=[f"bq{q}_bk{k}" for q, k in BLOCK_SHAPES])
def test_attention_ref_matches_jax_block_shapes(blocks):
    arrays = _inputs(BLOCK_CASE, seed=1)
    port = _f32(attention_ref(*_port(arrays, "float32"), causal=True))
    jfa = _f32(jax_flash_attention(*_jax(arrays, "float32"), causal=True,
                                   block_q=blocks[0], block_k=blocks[1], interpret=True))
    np.testing.assert_allclose(port, jfa, atol=2e-5, rtol=2e-5)


# head dims that the kernel carries in a larger tile (80, 96, 192): the
# function the card has to meet there, GQA causal and windowed
ODD_D_CASES = [
    (2, 128, 128, 6, 2, 80, True, None, None, 0, "float32"),
    (1, 256, 256, 4, 1, 80, True, 64, None, 0, "float32"),
    (1, 128, 128, 4, 2, 96, True, None, None, 0, "bfloat16"),
    (1, 128, 256, 2, 1, 192, True, 100, None, 128, "float32"),
]


@pytest.mark.parametrize("case", ODD_D_CASES, ids=[f"D{c[5]}_case{i}" for i, c in enumerate(ODD_D_CASES)])
def test_ops_attention_at_odd_head_dims_matches_jax(case):
    """ops.attention on the CPU (the plain version) at D 80, 96 and 192 against
    the Pallas kernel in interpret mode and the JAX oracle, same numpy inputs;
    the tolerances of tests/test_kernels.py (2e-5 fp32, 2e-2 bf16)."""
    dtype = case[-1]
    arrays = _inputs(case, seed=case[5])
    port = _f32(ops.attention(*_port(arrays, dtype), **_kw(case)))
    jref = _f32(jax_attention_ref(*_jax(arrays, dtype), **_kw(case)))
    jfa = _f32(jax_flash_attention(*_jax(arrays, dtype), **_kw(case), interpret=True))
    tol = TOL[dtype]
    np.testing.assert_allclose(port, jref, atol=tol, rtol=tol)
    np.testing.assert_allclose(port, jfa, atol=tol, rtol=tol)


def test_attention_ref_fully_masked_rows_are_zero():
    # window 1 with q_offset past every key: no row has a key to attend
    q, k, v = _port(_inputs((1, 8, 4, 2, 1, 64)), "float32")
    out = attention_ref(q, k, v, causal=True, window=1, q_offset=16)
    assert torch.equal(out, torch.zeros_like(out))


def test_ops_auto_on_cpu_takes_ref():
    case = ATTN_CASES[2]
    q, k, v = _port(_inputs(case), "float32")
    before = fa.LAUNCHES
    out = ops.attention(q, k, v, **_kw(case), impl="auto")
    assert fa.LAUNCHES == before
    assert torch.equal(out, attention_ref(q, k, v, **_kw(case)))


def test_ops_cuda_on_cpu_raises():
    q, k, v = _port(_inputs(ATTN_CASES[0]), "float32")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fa.flash_attention(q, k, v)


def test_ops_unknown_impl_raises():
    q, k, v = _port(_inputs(ATTN_CASES[0]), "float32")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(q, k, v, impl="pallas")


def test_kernel_modules_import_without_nvcc():
    """Importing needs no toolkit; the build, asked for without one, raises."""
    env = {**os.environ, "PATH": "", "CUDA_HOME": "/nonexistent"}
    code = (
        "import repro_torch.kernels.ops, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.mamba_scan, repro_torch.kernels.decode_attention\n"
        "from repro_torch.kernels import _build\n"
        "try:\n"
        "    _build.build_all()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('build_all did not raise without nvcc')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


# K1's host-side plan: the route by dtype, the kv tile by head dim, and the
# TMA tensor maps (dims, byte strides, boxes) of the bf16 route, with its
# refusals. It needs no card and no nvcc, so it runs here on CPU tensors.
@pytest.mark.parametrize("D,bk", [(64, 64), (128, 128), (256, 64)])
def test_plan_tiles_by_head_dim(D, bk):
    q = torch.zeros(2, 300, 4, D, dtype=torch.bfloat16)
    k = torch.zeros(2, 333, 2, D, dtype=torch.bfloat16)
    p = fa.plan(q, k, k)
    assert (p.route, p.block_q, p.block_k) == ("wgmma", 128, bk)
    qm, km, vm = p.maps
    assert qm == fa.TensorMap(dims=(D, 4, 300, 2), strides=(2 * D, 8 * D, 2400 * D),
                              box=(64, 1, 128, 1), slots=(1, 2, 3))
    assert km == vm == fa.TensorMap(dims=(D, 2, 333, 2), strides=(2 * D, 4 * D, 1332 * D),
                                    box=(64, 1, bk, 1), slots=(1, 2, 3))
    assert len(qm.flat()) == 14


def test_plan_fp32_takes_the_cuda_core_route():
    q = torch.zeros(1, 16, 2, 64)
    assert fa.plan(q, q, q) == fa.Plan("fp32", 64, 64, 64, 64)


@pytest.mark.parametrize("D,tile,bk", [(80, 128, 128), (96, 128, 128), (192, 256, 64)])
def test_plan_carries_odd_head_dims_in_the_next_tile(D, tile, bk):
    """80 and 96 run in the D 128 tile, 192 in the D 256 one: the maps keep the
    real D as their innermost extent (TMA fills the box's columns past it with
    zeros), so the row strides are those of the real rows."""
    q = torch.zeros(2, 300, 4, D, dtype=torch.bfloat16)
    k = torch.zeros(2, 333, 2, D, dtype=torch.bfloat16)
    p = fa.plan(q, k, k)
    assert (p.route, p.block_q, p.block_k, p.head_dim, p.tile_d) == ("wgmma", 128, bk, D, tile)
    qm, km, vm = p.maps
    assert qm == fa.TensorMap(dims=(D, 4, 300, 2), strides=(2 * D, 8 * D, 2400 * D),
                              box=(64, 1, 128, 1), slots=(1, 2, 3))
    assert km == vm == fa.TensorMap(dims=(D, 2, 333, 2), strides=(2 * D, 4 * D, 1332 * D),
                                    box=(64, 1, bk, 1), slots=(1, 2, 3))
    assert all(s % 16 == 0 for s in qm.strides)  # rows of 160, 192, 384 bytes: TMA's 16-byte rule
    # the fp32 route has a tile of its own at 192, and carries 80 and 96 in 128
    q32 = q.float()
    assert fa.plan(q32, q32, q32) == fa.Plan("fp32", 64, 64, D, 192 if D == 192 else 128)


def test_plan_refuses_head_dims_the_kernel_does_not_take():
    for D in (32, 72, 160):
        q = torch.zeros(1, 16, 2, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=rf"head dim {D} not in \(64, 80, 96, 128, 192, 256\)"):
            fa.plan(q, q, q)


def test_plan_reads_fused_qkv_views_at_head_dim_80():
    """A fused projection at D 80: head slices 160 bytes apart, which TMA loads."""
    qkv = torch.zeros(2, 96, 6, 80, dtype=torch.bfloat16)
    qm, km, _ = fa.plan(qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]).maps
    assert qm.dims == (80, 4, 96, 2) and qm.strides == (160, 960, 92160)
    assert km.dims == (80, 96, 2, 1) and km.strides == (960, 92160, 184320) and km.slots == (3, 1, 2)


def test_plan_reads_fused_qkv_views():
    """q, k, v as head slices of one projection: strides of the whole row, no copy."""
    qkv = torch.zeros(2, 96, 6, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:5], qkv[:, :, 5:6]
    qm, km, vm = fa.plan(q, k, v).maps
    assert qm.dims == (64, 4, 96, 2) and qm.strides == (128, 768, 73728)
    # k, v have one head: that axis goes outermost, past the batch's span
    assert km.dims == (64, 96, 2, 1) and km.strides == (768, 73728, 147456)
    assert km.box == (64, 64, 1, 1) and km.slots == (3, 1, 2)
    assert vm.dims == km.dims and vm.strides == km.strides


def test_plan_orders_axes_by_stride():
    """A head-major tensor viewed as (B, S, H, D): the map's dims follow the strides."""
    q = torch.zeros(2, 4, 100, 128, dtype=torch.bfloat16).transpose(1, 2)
    qm = fa.plan(q, q, q).maps[0]
    assert qm.dims == (128, 100, 4, 2) and qm.strides == (256, 25600, 102400)
    assert qm.box == (64, 128, 1, 1) and qm.slots == (2, 1, 3)


def test_plan_refuses_what_tma_cannot_load():
    k = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    buf = torch.zeros(1, 64, 132, dtype=torch.bfloat16)
    q_odd = buf.as_strided((1, 64, 2, 64), (64 * 132, 132, 64, 1))  # rows 264 bytes apart
    with pytest.raises(ValueError, match="q's row stride is 264 bytes"):
        fa.plan(q_odd, k, k)
    flat = torch.zeros(64 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="v starts 8 bytes past a 16-byte boundary"):
        fa.plan(k, k, flat[4:].view(1, 64, 1, 64))
    heads = torch.zeros(1, 8, 3, 72, dtype=torch.bfloat16)[..., :64]  # heads 144 bytes apart: loads
    assert fa.plan(heads, heads, heads).maps[0].strides == (144, 432, 3456)
    odd_heads = torch.zeros(1, 8, 3, 68, dtype=torch.bfloat16)[..., :64]  # 136 bytes apart
    with pytest.raises(ValueError, match="q's head stride is 136 bytes"):
        fa.plan(odd_heads, heads, heads)


# tests/test_kernels.py MAMBA_CASES: B, T, Di, N, Pallas block_channels, chunk, dtype
MAMBA_CASES = [
    (2, 128, 256, 16, 128, 64, "float32"),
    (1, 256, 512, 16, 256, 128, "float32"),
    (2, 64, 128, 8, 128, 64, "float32"),
    (1, 128, 256, 16, 128, 128, "bfloat16"),
]
# the tolerances of tests/test_kernels.py::test_mamba_scan_matches_oracle: both
# sides scan in fp32; bf16 rounds x, dt and y
MAMBA_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _mamba_arrays(case, seed=0):
    """The inputs of tests/test_kernels.py, made with numpy: x, dt = softplus(n) * 0.1,
    A = -exp(0.5 n), and B, C, D in fp32."""
    B, T, Di, N = case[:4]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Di)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((B, T, Di)), 0.0) * 0.1).astype(np.float32)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.5).astype(np.float32)
    rest = [rng.standard_normal(s).astype(np.float32) for s in ((B, T, N), (B, T, N), (Di,))]
    return [x, dt, A, *rest]


def _mamba_port(arrays, dtype):
    x, dt, *rest = (torch.from_numpy(a) for a in arrays)
    return [x.to(getattr(torch, dtype)), dt.to(getattr(torch, dtype)), *rest]


def _mamba_jax(arrays, dtype):
    x, dt, *rest = (jnp.asarray(a) for a in arrays)
    return [x.astype(getattr(jnp, dtype)), dt.astype(getattr(jnp, dtype)), *rest]


# Inputs that remember: a ragged T below the Pallas chunk and one step past
# it, then a slow-decay case like the mixer's init, where the state carried
# over hundreds of steps dominates y. (B, T, Di, N, Pallas block_channels,
# Pallas chunk, dtype, slow)
MEMORY_CASES = [
    (1, 100, 64, 16, 64, 100, "float32", False),
    (2, 129, 64, 16, 64, 129, "float32", False),
    (1, 1024, 64, 16, 64, 128, "float32", True),
    (1, 1024, 64, 16, 64, 128, "bfloat16", True),
]
SLOW_CASES = [c for c in MEMORY_CASES if c[7]]
RESTART = 128  # steps after which the control drops the state


def _slow_decay_arrays(case, seed=0):
    """dt log-uniform in [1e-3, 1e-1] and A = -(1 .. N), as the mamba mixer is
    initialised: the state lasts hundreds of steps."""
    B, T, Di, N = case[:4]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Di)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, T, Di))).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Di, 1))
    rest = [rng.standard_normal(s).astype(np.float32) for s in ((B, T, N), (B, T, N), (Di,))]
    return [x, dt, A, *rest]


def _memory_arrays(case):
    return _slow_decay_arrays(case) if len(case) > 7 and case[7] else _mamba_arrays(case)


def _restarted_scan(x, dt, A, B, C, D, every=RESTART):
    """The scan with its state dropped to 0 every ``every`` steps: the control
    that a case sees a state lost on the way."""
    return torch.cat([mamba_scan_ref(x[:, s : s + every], dt[:, s : s + every], A, B[:, s : s + every],
                                     C[:, s : s + every], D) for s in range(0, x.shape[1], every)], dim=1)


@pytest.mark.parametrize("case", MAMBA_CASES + MEMORY_CASES,
                         ids=[f"case{i}" for i in range(len(MAMBA_CASES + MEMORY_CASES))])
def test_mamba_scan_ref_matches_jax(case):
    dtype = case[6]
    arrays = _memory_arrays(case)
    port = mamba_scan_ref(*_mamba_port(arrays, dtype))
    assert port.dtype == getattr(torch, dtype) and port.shape == arrays[0].shape
    jref = jax_mamba_scan_ref(*_mamba_jax(arrays, dtype))
    jker = jax_mamba_scan(*_mamba_jax(arrays, dtype), block_channels=case[4], chunk=case[5],
                          interpret=True)
    tol = MAMBA_TOL[dtype]
    np.testing.assert_allclose(_f32(port), _f32(jref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(port), _f32(jker), atol=tol, rtol=tol)


def test_mamba_ops_auto_on_cpu_takes_ref():
    args = _mamba_port(_mamba_arrays(MAMBA_CASES[2]), "float32")
    before = ms.LAUNCHES
    out = ops.mamba_scan(*args, impl="auto")
    assert ms.LAUNCHES == before
    assert torch.equal(out, mamba_scan_ref(*args))


def test_mamba_ops_cuda_on_cpu_raises():
    args = _mamba_port(_mamba_arrays(MAMBA_CASES[2]), "float32")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ops.mamba_scan(*args, impl="cuda")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ms.mamba_scan(*args)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.mamba_scan(*args, impl="interpret")


@pytest.mark.parametrize("case", SLOW_CASES, ids=[c[6] for c in SLOW_CASES])
def test_mamba_slow_decay_case_fails_the_bar_with_a_dropped_state(case):
    """The control: the same inputs with the state dropped every 128 steps
    miss the bar, so the case sees a state lost inside a long scan."""
    dtype = case[6]
    args = _mamba_port(_memory_arrays(case), dtype)
    ref = mamba_scan_ref(*args).float()
    tol = MAMBA_TOL[dtype]
    assert not torch.allclose(_restarted_scan(*args).float(), ref, atol=tol, rtol=tol)


def test_mamba_slow_decay_case_sees_the_state_at_every_restarts_end():
    """In the slow-decay case the state held over from before a restart still
    moves y by more than the fp32 bar 128 steps later, at every restart: a
    state that is lost shows over the whole span, not only after the loss."""
    case = SLOW_CASES[0]
    B, T = case[:2]
    args = _mamba_port(_memory_arrays(case), "float32")
    held = mamba_scan_ref(*args) - _restarted_scan(*args)
    last = held.reshape(B, T // RESTART, RESTART, -1)[:, 1:, -1].abs().amax(dim=(0, 2))
    assert last.min() > MAMBA_TOL["float32"]


# K2's host-side plan: the grid and shared memory by shape, and what it
# refuses
def _scan_tensors(B, T, Di, N, dtype=torch.bfloat16, bc_dtype=torch.bfloat16, strided=True):
    x = torch.zeros(B, T, Di, dtype=dtype)
    if strided:  # B and C as slices of the x -> (dt, B, C) projection, as in the mixer
        xdbc = torch.zeros(B, T, 256 + 2 * N, dtype=bc_dtype)
        Bm, Cm = xdbc[..., 256 : 256 + N], xdbc[..., 256 + N :]
    else:
        Bm, Cm = torch.zeros(B, T, N, dtype=bc_dtype), torch.zeros(B, T, N, dtype=bc_dtype)
    return x, x.clone(), torch.zeros(Di, N), Bm, Cm, torch.zeros(Di)


# (B, T, Di): tiles and blocks, one block per (64-channel tile, batch row)
PLAN_CASES = [
    ((2, 2048, 8192), 128, 256),  # jamba's prefill
    ((1, 2048, 8192), 128, 128),  # batch 1
    ((2, 1000, 8100), 127, 254),  # ragged T and Di
    ((1, 1, 64), 1, 1),  # one step, one tile
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[f"plan{i}" for i in range(len(PLAN_CASES))])
def test_mamba_plan_grid_by_shape(case):
    (B, T, Di), tiles, blocks = case
    p = ms.plan(*_scan_tensors(B, T, Di, 16))
    assert (p.lanes, p.channels, p.tiles, p.blocks) == (4, 64, tiles, blocks)
    # two stages of dt and x (64 rows of 20) and of B and C (16 x 16), and
    # 128 rows of 36 partial y sums, in fp32: static shared memory, no opt-in
    assert p.smem_bytes == 4 * (2 * 2 * 64 * 20 + 2 * 2 * 16 * 16 + 128 * 36) <= 48 * 1024


@pytest.mark.parametrize("N, lanes, channels", [(1, 4, 64), (16, 4, 64), (17, 8, 32), (32, 8, 32),
                                                (33, 16, 16), (64, 16, 16)])
def test_mamba_plan_lanes_by_state_count(N, lanes, channels):
    p = ms.plan(*_scan_tensors(1, 64, 100, N, strided=False))
    assert (p.lanes, p.channels, p.tiles) == (lanes, channels, -(-100 // channels))


def test_mamba_plan_refuses_what_the_kernel_does_not_take():
    args = _scan_tensors(1, 64, 128, 16)
    with pytest.raises(ValueError, match="states"):
        ms.plan(*_scan_tensors(1, 64, 128, ms.MAX_STATES + 1, strided=False))
    with pytest.raises(TypeError, match="float16"):
        ms.plan(args[0].half(), args[1].half(), *args[2:])
    with pytest.raises(TypeError, match="B and C"):
        ms.plan(*args[:3], args[3].float(), *args[4:])
    with pytest.raises(TypeError, match="A and D must be float32"):
        ms.plan(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(ValueError, match="rows must be contiguous"):
        ms.plan(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="rows must be contiguous"):
        ms.plan(*args[:3], torch.zeros(1, 64, 32, dtype=torch.bfloat16)[..., ::2], *args[4:])
    with pytest.raises(ValueError, match="exceed the grid"):
        ms._plan(2**31, 64, 16)
    with pytest.raises(ValueError, match="B is"):
        ms.plan(*args[:3], args[3][:, :-1], *args[4:])


# K4's host-side plan: the route by dtype and row block, and on the wgmma route
# the TMA tensor maps of lhs (K, M), rhs (N, K, G) and the output (N, block_m,
# M / block_m), at the paths' shapes.
def _gmm_plan(M, K, N, G, n_blocks, dtype=torch.bfloat16, out_dtype=None):
    return gk.plan(torch.zeros(M, K, dtype=dtype), torch.zeros(G, K, N, dtype=dtype),
                   torch.zeros(n_blocks, dtype=torch.int32), out_dtype)


@pytest.mark.parametrize("block_m,route", [(1, "mma_sync"), (3, "mma_sync"), (16, "mma_sync"), (17, "wgmma"),
                                           (200, "wgmma"), (1024, "wgmma")])
def test_gmm_plan_route_by_row_block(block_m, route):
    p = _gmm_plan(4 * block_m, 64, 64, 4, 4)
    assert (p.route, p.block_m) == (route, block_m)
    assert (p.tile_m, p.tile_n) == ((128, 256) if route == "wgmma" else (16, 64))
    assert len(p.maps) == (3 if route == "wgmma" else 0)
    assert _gmm_plan(4 * block_m, 64, 64, 4, 4, torch.float32) == gk.Plan("fp32", block_m, 64, 64)


# (M, K, N, G): granite's up/gate and down, jamba's up/gate and down (B 2, S 2048)
GMM_PATH_SHAPES = {"granite_up": (40960, 1536, 512, 40), "granite_down": (40960, 512, 1536, 40),
                   "jamba_up": (10240, 4096, 14336, 16), "jamba_down": (10240, 14336, 4096, 16)}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(GMM_PATH_SHAPES))
def test_gmm_plan_maps_at_path_shapes(name, out_dtype):
    M, K, N, G = GMM_PATH_SHAPES[name]
    p = _gmm_plan(M, K, N, G, G, out_dtype=out_dtype)
    assert p.route == "wgmma" and p.block_m == M // G
    lm, rm, om = p.maps
    # lhs (M, K) as (K, M, 1, 1): one box is 64 columns of the tile's 128 rows
    assert lm == gk.TensorMap(dims=(K, M, 1, 1), strides=(2 * K, 2 * K * M, 2 * K * M), box=(64, 128, 1, 1))
    # rhs (G, K, N) as (N, K, G, 1): a box is 64 columns of a K step's 64 rows
    assert rm == gk.TensorMap(dims=(N, K, G, 1), strides=(2 * N, 2 * N * K, 2 * N * K * G), box=(64, 64, 1, 1))
    # out (M, N) as (N, block_m, G, 1): rows past a row block lie outside the
    # map, so a store box of the warpgroup's 64 rows stops at its row block
    s, C = out_dtype.itemsize, M // G
    assert om == gk.TensorMap(dims=(N, C, G, 1), strides=(s * N, s * N * C, s * N * M), box=(128 // s, 64, 1, 1))
    assert all(s % 16 == 0 and s < 2**40 for m in p.maps for s in m.strides)
    assert len(gk._plan_array(p)) == 33


def test_gmm_plan_output_map_stops_at_row_blocks():
    """Row blocks of 200 rows (128 + 72): the output map's row extent is the
    row block, so the second tile's store clips at row 200 of its block."""
    p = _gmm_plan(600, 200, 72, 3, 3, out_dtype=torch.float32)
    assert p.route == "wgmma" and p.block_m == 200
    assert p.maps[2].dims == (72, 200, 3, 1) and p.maps[2].box == (32, 64, 1, 1)


# K3's host-side plan: the route by dtype and head dim (bf16 with D % 64 == 0
# and D <= 512 on wgmma, chunk 128; every other bf16 D and fp32 on the CUDA
# cores, chunk 64), the grids, the shared memory, and on the wgmma route the
# TMA tensor maps of q, k, v and the state scratch, with its refusals.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 512, 576])
def test_mlstm_plan_route_by_dtype_and_head_dim(D, dtype):
    B, T, H = 2, 1000, 4
    q = torch.zeros(B, T, H, D, dtype=dtype)
    p = ml.plan(q, q, q)
    if dtype == torch.bfloat16 and D in (64, 128, 512):
        nc, nt = 8, -(-D // 128)  # 1000 = 7 * 128 + 104
        assert (p.route, p.chunk) == ("wgmma", ml.WGMMA_CHUNK)
        assert p.grids == (("gates", (8, 1, 1)), ("states", (nt * nt, 8, 1)), ("output", (nc, 8, 1)))
        smem = dict(p.smem)
        assert smem["states"] == 199712 and smem["output"] == 1024 + D * 256 + 98304 + 112 + 512
        assert max(smem.values()) <= ml.SMEM_LIMIT
        assert len(p.maps) == 5 and len(ml._plan_array(p)) == 70
    else:
        nc, nd = 16, -(-D // 64)  # 1000 = 15 * 64 + 40
        assert p == ml.Plan("cuda_cores", ml.CHUNK, (("gates", (8, 1, 1)), ("states", (nd * nd, 8, 1)),
                                                     ("scores", (nc, 8, 1)), ("output", (nd, nc, 8))))


def test_mlstm_plan_maps_at_the_prefill_shape():
    """xlstm-350m's prefill (B 2, T 2048, H 4, D 512): boxes of 64 columns and
    one chunk of rows; the state scratch (B*H*nc, 2 * 4 tiles, D, 128) in
    boxes of 64 x 64; the output in boxes of 64 rows; one chunk-long sequence
    launches no states pass."""
    q = torch.zeros(2, 2048, 4, 512, dtype=torch.bfloat16)
    p = ml.plan(q, q, q)
    qm, km, vm, cm, om = p.maps
    assert qm == km == vm == fa.TensorMap(dims=(512, 4, 2048, 2), strides=(1024, 4096, 8388608),
                                          box=(64, 1, 128, 1), slots=(1, 2, 3))
    assert cm == fa.TensorMap(dims=(128, 512, 8, 128), strides=(256, 131072, 1048576), box=(64, 64, 1, 1),
                              slots=(0, 0, 0))
    assert om == fa.TensorMap(dims=(512, 4, 2048, 2), strides=(1024, 4096, 8388608), box=(64, 1, 64, 1),
                              slots=(1, 2, 3))
    assert p.grids[1] == ("states", (16, 8, 1)) and p.grids[2] == ("output", (16, 8, 1))
    short = torch.zeros(1, 100, 2, 64, dtype=torch.bfloat16)
    assert [name for name, _ in ml.plan(short, short, short).grids] == ["gates", "output"]


def test_mlstm_plan_reads_strided_views():
    """q, k, v as head-major slices of one (B, H, T, 3D) projection: every axis
    but D strided, the map's dims ordered by stride, no copy."""
    B, T, H, D = 2, 320, 2, 128
    qkv = torch.zeros(B, H, T, 3 * D, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * D:(i + 1) * D].transpose(1, 2) for i in range(3))
    maps = ml.plan(q, k, v).maps
    for m in maps[:3]:
        assert m.dims == (D, T, H, B) and m.strides == (768, 245760, 491520)
        assert m.box == (64, 128, 1, 1) and m.slots == (2, 1, 3)


def test_mlstm_plan_refuses_what_it_cannot_launch():
    k = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    flat = torch.zeros(1 + 128 * 2 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mlstm: q starts 2 bytes past a 16-byte boundary"):
        ml.plan(flat[1:].view(1, 128, 2, 64), k, k)
    odd_heads = torch.zeros(1, 128, 2, 68, dtype=torch.bfloat16)[..., :64]  # heads 136 bytes apart
    with pytest.raises(ValueError, match="mlstm: v's head stride is 136 bytes"):
        ml.plan(k, k, odd_heads)
    # fp32 takes no TMA: the CUDA-core route reads the same layout
    odd32 = torch.zeros(1, 128, 2, 68)[..., :64]
    assert ml.plan(odd32, odd32, odd32).route == "cuda_cores"
    long_t = torch.zeros(1, dtype=torch.bfloat16).expand(1, 128 * 65535 + 1, 1, 64)
    with pytest.raises(ValueError, match="65536 chunks exceed 65535"):
        ml.plan(long_t, long_t, long_t)
    many = torch.zeros(1, dtype=torch.float32).expand(65536, 64, 1, 64)
    with pytest.raises(ValueError, match="B\\*H=65536 sequences"):
        ml.plan(many, many, many)


# The wgmma route's precision plan in plain torch (mlstm_rounded_scan): W, the
# key-weighted k and the state split into bf16 hi + lo, the denominator from
# fp32 values. It holds the bf16 bar against the chunked scan and against the
# Pallas kernel (interpret mode) at the route's chunk; the same arithmetic
# with those operands rounded to bf16 once fails it (the cancelling
# denominator amplifies their 2^-9 error).
MLSTM_EMU_SHAPE = (1, 512, 2, 128)
MLSTM_BF16_TOL = 1e-2


def _mlstm_arrays(B, T, H, D, seed=0):
    """The inputs of tests/test_kernels.py: q, k, v ~ N(0, 1), i ~ N(0, 1), f ~ N(2, 2)."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3)]
    gates = [rng.standard_normal((B, T, H)).astype(np.float32),
             (rng.standard_normal((B, T, H)) * 2.0 + 2.0).astype(np.float32)]
    return qkv + gates


def _mlstm_port(arrays, dtype=torch.bfloat16):
    q, k, v, ig, fg = (torch.from_numpy(a) for a in arrays)
    return [q.to(dtype), k.to(dtype), v.to(dtype), ig, fg]


def _mlstm_rel(out, ref):
    out, ref = _f32(out), _f32(ref)
    return float((np.abs(out - ref) / (np.abs(ref) + 1e-2)).max())


def test_mlstm_emulated_split_operands_hold_the_bf16_bar():
    arrays = _mlstm_arrays(*MLSTM_EMU_SHAPE)
    args = _mlstm_port(arrays)
    ref = mlstm_chunked_scan(*args, chunk=ml.WGMMA_CHUNK)
    jax_args = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] + [jnp.asarray(a) for a in arrays[3:]]
    pallas = jax_mlstm_chunkwise(*jax_args, chunk=ml.WGMMA_CHUNK, interpret=True)
    split = mlstm_rounded_scan(*args)
    assert split.dtype == torch.bfloat16 and split.shape == args[0].shape
    assert _mlstm_rel(split, ref) < MLSTM_BF16_TOL
    assert _mlstm_rel(split, pallas) < MLSTM_BF16_TOL
    plain = mlstm_rounded_scan(*args, operands="bf16")
    assert _mlstm_rel(plain, ref) > MLSTM_BF16_TOL > _mlstm_rel(split, ref)


def test_mlstm_emulated_tf32_operands_fail_the_bf16_bar():
    args = _mlstm_port(_mlstm_arrays(*MLSTM_EMU_SHAPE))
    ref = mlstm_chunked_scan(*args, chunk=ml.WGMMA_CHUNK)
    assert _mlstm_rel(mlstm_rounded_scan(*args, operands="tf32"), ref) > MLSTM_BF16_TOL


def test_mlstm_emulation_pads_a_ragged_T_as_the_kernel_masks_it():
    """fp32 operands and inputs, T = 2 * 128 + 44: the model itself is the
    chunkwise algorithm (the quadratic oracle within the fp32 bar)."""
    args = _mlstm_port(_mlstm_arrays(2, 300, 2, 64, seed=1), torch.float32)
    out = mlstm_rounded_scan(*args, operands="exact")
    assert out.shape == args[0].shape
    assert _mlstm_rel(out, mlstm_chunkwise_ref(*args)) < 2e-3


# K5's plain version and host-side plan. The (g, D) of every attention layer
# of the registry's configs (full and smoke): g = n_heads / n_kv_heads.
DECODE_GD = [(1, 64), (1, 80), (1, 96), (2, 256), (3, 64), (4, 128), (4, 256), (12, 192)]
DECODE_SMOKE_GD = [(1, 16), (1, 32), (2, 16), (2, 32), (4, 16)]
DECODE_L = 12


def _decode_arrays(B, L, Hkv, g, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, 1, Hkv * g, D), (B, L, Hkv, D), (B, L, Hkv, D))]


def test_decode_head_shapes_cover_the_registry():
    from repro_torch.configs import all_configs, smoke_config

    def gd(c):
        return (c.n_heads // c.n_kv_heads, c.resolved_head_dim)

    attn = {n: c for n, c in all_configs().items() if {"attn", "local"} & set(c.layer_kinds())}
    assert {gd(c) for c in attn.values()} == set(DECODE_GD)
    assert {gd(smoke_config(n)) for n in attn} == set(DECODE_SMOKE_GD)


@pytest.mark.parametrize("fill", [1, DECODE_L - 1, DECODE_L])
@pytest.mark.parametrize("g,D", DECODE_GD + DECODE_SMOKE_GD)
def test_decode_attention_ref_matches_jax(g, D, fill):
    arrays = _decode_arrays(2, DECODE_L, 2, g, D)
    out = decode_attention_ref(*_port(arrays, "float32"), fill)
    want = jax_decode_attention(*_jax(arrays, "float32"), fill)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("g,D", [(4, 128), (12, 192)])
def test_decode_attention_ref_matches_jax_in_bf16(g, D):
    arrays = _decode_arrays(2, DECODE_L, 2, g, D, seed=1)
    out = decode_attention_ref(*_port(arrays, "bfloat16"), 7)
    want = jax_decode_attention(*_jax(arrays, "bfloat16"), 7)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(want), atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def test_decode_attention_ref_on_a_full_ring():
    """A sliding-window ring that has wrapped holds its slots out of order and
    passes fill_len = L: the same output as the slots in order."""
    q, k, v = _decode_arrays(2, DECODE_L, 2, 4, 256, seed=2)
    ring = [np.roll(t, 5, axis=1) for t in (k, v)]
    out = decode_attention_ref(*_port([q, *ring], "float32"), DECODE_L)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_decode_attention(*_jax([q, *ring], "float32"),
                                                                            DECODE_L)),
                               atol=TOL["float32"], rtol=TOL["float32"])
    in_order = decode_attention_ref(*_port([q, k, v], "float32"), DECODE_L)
    np.testing.assert_allclose(out.numpy(), in_order.numpy(), atol=TOL["float32"], rtol=TOL["float32"])


def test_decode_ops_auto_on_cpu_takes_ref():
    q, k, v = _port(_decode_arrays(2, DECODE_L, 2, 4, 64), "float32")
    before = da.LAUNCHES
    out = ops.decode_attention(q, k, v, 5, impl="auto")
    assert da.LAUNCHES == before
    assert torch.equal(out, decode_attention_ref(q, k, v, 5))
    assert torch.equal(ops.decode_attention(q, k, v, 5, impl="ref"), out)


def test_decode_ops_cuda_on_cpu_raises():
    q, k, v = _port(_decode_arrays(2, DECODE_L, 2, 4, 64), "float32")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ops.decode_attention(q, k, v, 5, impl="cuda")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        da.decode_attention(q, k, v, 5)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.decode_attention(q, k, v, 5, impl="interpret")


def _decode_plan(B, L, Hkv, g, D, fill, dtype=torch.bfloat16, sms=da.H100_SMS):
    q = torch.zeros(B, 1, Hkv * g, D, dtype=dtype)
    k = torch.zeros(B, L, Hkv, D, dtype=dtype)
    return da.plan(q, k, k, fill, sms)


# (B, L, Hkv, g, D, fill, splits): mixtral's and jamba's decode cells (64
# streams at ~430 and ~1,250 slots) take one split; a lone stream at 4,096
# slots takes many; the plan never cuts more splits than filled tiles
DECODE_PLANS = [
    (64, 4096, 8, 4, 128, 431, 1),
    (64, 4096, 8, 4, 128, 1250, 1),
    (64, 4096, 8, 4, 128, 4096, 1),
    (1, 4096, 8, 4, 128, 4096, 32),
    (1, 4096, 8, 4, 128, 431, 14),
    (1, 4096, 8, 4, 128, 1, 1),
    (2, 1024, 1, 4, 256, 1024, 32),
    (1, 4096, 8, 12, 192, 4096, 32),
]


@pytest.mark.parametrize("case", DECODE_PLANS, ids=[f"plan{i}" for i in range(len(DECODE_PLANS))])
def test_decode_plan_splits_by_shape(case):
    *shape, fill, splits = case
    p = _decode_plan(*shape, fill)
    assert p.splits == splits and p.tiles == -(-fill // da.TILE)
    # whole tiles a split: only the last split's last tile is ragged, and no split is empty
    assert (p.splits - 1) * p.tiles_per_split < p.tiles <= p.splits * p.tiles_per_split
    B, _, Hkv, g, D = shape
    assert p.blocks == B * Hkv * p.splits and p.launches == (1 if p.splits == 1 else 2)
    assert p.smem_bytes == da.smem_bytes(torch.bfloat16, D, g) <= 232_448


def test_decode_plan_adapts_to_the_card_and_the_cache_type():
    """Fewer SMs, fewer splits; an fp32 cache moves twice the bytes a tile,
    so fewer blocks keep the same bytes in flight."""
    assert _decode_plan(1, 4096, 8, 4, 128, 4096, sms=66).splits == 16
    assert _decode_plan(1, 4096, 8, 4, 128, 4096, torch.float32).splits == 16
    assert _decode_plan(1, 4096, 8, 4, 128, 4096).smem_bytes == da.smem_bytes(torch.bfloat16, 128, 4)
    assert da.smem_bytes(torch.float32, 256, 16) <= 232_448  # the largest block the kernel takes


def test_decode_plan_reads_strided_cache_views():
    """The per-layer view of a stacked cache, and heads sliced from wider rows:
    read in place through their strides."""
    stacked = torch.zeros(3, 2, 64, 8, 128, dtype=torch.bfloat16)
    q = torch.zeros(2, 1, 32, 128, dtype=torch.bfloat16)
    assert _decode_plan(2, 64, 8, 4, 128, 64) == da.plan(q, stacked[1], stacked[2], 64)
    wide = torch.zeros(2, 64, 8, 136, dtype=torch.bfloat16)[..., :128]  # rows 272 bytes apart
    assert da.plan(q, wide, wide, 10).splits >= 1
    heads = torch.zeros(2, 64, 16, 128, dtype=torch.bfloat16)[:, :, ::2]  # every other head
    assert da.plan(q, heads, heads, 10).tiles == 1


def test_decode_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="a multiple of 8 up to 256"):
        _decode_plan(1, 64, 2, 4, 100, 10)
    with pytest.raises(ValueError, match="a multiple of 8 up to 256"):
        _decode_plan(1, 64, 2, 4, 264, 10)
    with pytest.raises(ValueError, match="17 query heads a kv head"):
        _decode_plan(1, 64, 2, 17, 64, 10)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _decode_plan(1, 64, 2, 4, 64, 10, torch.float16)
    for fill in (0, 65, 3.0, True):
        with pytest.raises(ValueError, match="fill_len"):
            _decode_plan(1, 64, 2, 4, 64, fill)
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q must be"):
        da.plan(q.expand(1, 2, 8, 64), k, k, 10)
    with pytest.raises(ValueError, match="does not fit the cache"):
        da.plan(q[:, :, :7], k, k, 10)
    with pytest.raises(ValueError, match="one \\(B, L, Hkv, D\\) shape"):
        da.plan(q, k, k[:, :32], 10)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        da.plan(q, k.transpose(2, 3).contiguous().transpose(2, 3), k, 10)
    flat = torch.zeros(64 * 2 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must start on 16 bytes"):
        da.plan(q, k, flat[4:].view(1, 64, 2, 64), 10)  # 8 bytes past a 16-byte boundary
    odd = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16)[..., :64]  # heads 136 bytes apart
    with pytest.raises(ValueError, match="must start on 16 bytes"):
        da.plan(q, odd, odd, 10)
