"""The port's attention (repro_torch.kernels) against the JAX package's, on the CPU.

The JAX side runs its oracle and its Pallas kernel in interpret mode, as
tests/test_kernels.py does; the port's side runs its plain version, which is
what ``ops.attention`` picks for CPU tensors. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.ref import attention_ref as jax_attention_ref
import repro_torch.kernels.flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

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
