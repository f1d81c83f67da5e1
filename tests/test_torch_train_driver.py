"""The port's training driver (``repro_torch.launch.train``) on the CPU.

* It cuts gemma3-1b's smoke loss as the reference's driver must
  (tests/test_launch.py::test_train_driver_reduces_loss: the mean of the last
  5 losses below the first 5's by more than 0.3) and writes its last step.
* A run resumed from its own checkpoint repeats the straight run's losses and
  parameters bit for bit (same ops on the CPU, the batches deterministic in
  the step, the state restored exactly).
* A checkpoint the reference's driver wrote resumes in the port's: the
  port's steps 3-4 from the reference's step-2 state stay within 1e-2
  relative of the reference's own steps 3-4. Both trainers take an arch name
  and train in the smoke config's bf16, so this is the bf16 loss bar of
  tests/test_torch_train.py; the fp32 bars are held step by step in
  tests/test_torch_train_step.py.
"""

import shutil

import numpy as np
import pytest
import torch

from repro.launch.train import train as jax_train
from repro_torch.checkpoint import latest_step
from repro_torch.launch.train import train
from repro_torch.tree import leaves

BF16_RTOL = 1e-2
SMALL = {"steps": 4, "smoke": True, "global_batch": 4, "seq_len": 64, "ckpt_every": 2,
         "verbose": False}


def test_train_reduces_loss_and_writes_its_last_step(tmp_path):
    _, losses = train("gemma3_1b", steps=40, smoke=True, global_batch=4, seq_len=128, lr=2e-3,
                      ckpt_dir=str(tmp_path), ckpt_every=20, verbose=False, device="cpu")
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert latest_step(str(tmp_path)) == 40


def test_resumed_run_repeats_the_straight_run_bit_for_bit(tmp_path):
    stats = {}
    params, losses = train("gemma3_1b", ckpt_dir=str(tmp_path), device="cpu", stats=stats,
                           **SMALL)
    assert len(stats["step_s"]) == 4 and stats["restore_s"] is None
    assert [t["step"] for t in stats["timings"]] == [2, 4]
    shutil.rmtree(tmp_path / "step_00000004")
    resumed_stats = {}
    params2, losses2 = train("gemma3_1b", ckpt_dir=str(tmp_path), device="cpu",
                             stats=resumed_stats, **SMALL)
    assert resumed_stats["restore_s"] > 0 and len(losses2) == 2
    assert losses2 == losses[2:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(params2), leaves(params), strict=True))
    assert latest_step(str(tmp_path)) == 4


def test_port_resumes_from_the_references_checkpoint(tmp_path):
    _, want = jax_train("gemma3_1b", ckpt_dir=str(tmp_path), **SMALL)
    assert latest_step(str(tmp_path)) == 4
    shutil.rmtree(tmp_path / "step_00000004")
    _, got = train("gemma3_1b", ckpt_dir=str(tmp_path), device="cpu", **SMALL)
    assert len(got) == 2
    for g, w in zip(got, want[2:], strict=True):
        assert abs(g - w) <= BF16_RTOL * abs(w), (got, want)


def test_production_mesh_raises():
    # the production mesh needs a world of 256 ranks; this process is one
    with pytest.raises(ValueError, match="256 ranks"):
        train("gemma3_1b", steps=1, production_mesh=True, device="cpu")
