"""The port's int8 error-feedback compression (repro_torch.distributed.compression)
against the JAX package's, on the CPU.

Seeded inputs (a ragged size, an all-zero block, a block with one large
outlier) go through both packages: ``quantize_int8``'s codes equal the
reference's exactly and its scales bit for bit, as do ``dequantize_int8``
and ``ef_compress`` (the reference run eagerly, op by op: its divisions by a
tensor are true divisions, as the port's). ``compressed_psum`` runs on a
4-rank gloo world against the reference's ``shard_map`` over 4 CPU devices
(tests/torch_sharding_reference.py, run compiled): the int32 sums are exact,
so the reduced gradients agree within 1e-6 of their largest, and the new
error buffers within one ulp of the quantised target (XLA fuses the
subtraction into an FMA).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.compression import (
    _BLOCK,
    compressed_psum,
    dequantize_int8,
    ef_compress,
    quantize_int8,
)

HERE = os.path.dirname(__file__)
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
PSUM_RTOL = 1e-6
MEMBERS = 4


def _inputs():
    rng = np.random.default_rng(7)
    xs = {
        "ragged": rng.standard_normal(3 * _BLOCK + 517).astype(np.float32),
        "zero_block": np.concatenate([np.zeros(_BLOCK, np.float32),
                                      rng.standard_normal(_BLOCK).astype(np.float32)]),
        "matrix": (rng.standard_normal((96, 80)) * 1e-3).astype(np.float32),
        "outlier": np.concatenate([rng.standard_normal(_BLOCK - 1), [1e4]]).astype(np.float32),
    }
    arrays = {}
    for name, x in xs.items():
        arrays["x_" + name] = x
        arrays["e_" + name] = (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
    arrays["psum_g"] = rng.standard_normal((MEMBERS, 2 * _BLOCK + 300)).astype(np.float32)
    arrays["psum_e"] = (rng.standard_normal((MEMBERS, 2 * _BLOCK + 300)) * 1e-2).astype(np.float32)
    return arrays


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the reference's results, and the gloo world's: the
    reference's subprocess and the world run side by side."""
    d = tmp_path_factory.mktemp("compression")
    arrays = _inputs()
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sharding_reference.py"),
                            "compression", str(d / "in.npz"), str(d / "out.json")], env=env)
    try:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        mp.spawn(_psum_rank, args=(port, str(d)), nprocs=MEMBERS)
        assert ref.wait(timeout=600) == 0
    finally:
        if ref.poll() is None:
            ref.kill()
    return arrays, json.loads((d / "out.json").read_text()), d


@pytest.mark.parametrize("name", ["ragged", "zero_block", "matrix", "outlier"])
def test_quantize_dequantize_and_ef_compress_equal_the_references(case, name):
    arrays, ref, _ = case
    x, e = torch.as_tensor(arrays["x_" + name]), torch.as_tensor(arrays["e_" + name])
    want = ref["x_" + name]
    q, s, pad = quantize_int8(x)
    assert q.dtype == torch.int8 and pad == want["pad"]
    assert np.array_equal(q.numpy(), np.asarray(want["q"], np.int8))
    assert np.array_equal(s.numpy(), np.asarray(want["scale"], np.float32))
    assert np.array_equal(dequantize_int8(q, s, pad, tuple(x.shape)).numpy(),
                          np.asarray(want["deq"], np.float32))
    dec, err = ef_compress(x, e)
    assert np.array_equal(dec.numpy(), np.asarray(want["ef"], np.float32))
    assert np.array_equal(err.numpy(), np.asarray(want["ef_err"], np.float32))


def test_an_all_zero_block_keeps_its_floor_scale():
    q, s, pad = quantize_int8(torch.zeros(_BLOCK + 5))
    assert pad == _BLOCK - 5 and torch.all(q == 0)
    assert torch.all(s == torch.tensor(1e-12, dtype=torch.float32))


def _psum_rank(rank, port, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=MEMBERS)
    try:
        data = np.load(os.path.join(work, "in.npz"))
        g = {"w": torch.as_tensor(data["psum_g"][rank])}
        e = {"w": torch.as_tensor(data["psum_e"][rank])}
        red, new_e = compressed_psum(g, e)
        torch.save({"reduced": red["w"], "error": new_e["w"]},
                   os.path.join(work, f"psum_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_on_a_gloo_world_matches_the_references_shard_map(case):
    arrays, ref, work = case
    want_red = np.asarray(ref["psum"]["reduced"], np.float32)
    want_err = np.asarray(ref["psum"]["error"], np.float32)
    for r in range(MEMBERS):
        got = torch.load(work / f"psum_{r}.pt")
        err = float(np.max(np.abs(got["reduced"].numpy() - want_red[r])))
        assert err <= PSUM_RTOL * float(np.max(np.abs(want_red[r]))), (r, err)
        # the new error is target - decoded, a difference of near-equal
        # numbers: XLA's CPU backend forms it as one FMA, torch in two
        # roundings, so it may sit one ulp of the target apart
        target = np.abs(arrays["psum_g"][r] + arrays["psum_e"][r])
        err = np.abs(got["error"].numpy() - want_err[r])
        assert np.all(err <= np.spacing(target.astype(np.float32))), (r, float(err.max()))
        # the int32 sums are exact: every member decodes the same sum
        assert np.array_equal(got["reduced"].numpy(), torch.load(work / "psum_0.pt")["reduced"]
                              .numpy())
