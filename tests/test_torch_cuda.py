"""The port's CUDA kernel against its plain version, on the card.

Every test here carries the ``cuda`` marker and skips where there is no
card; this file imports no JAX, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref

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
