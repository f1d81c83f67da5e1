"""The check fails a run whose timed path is broken underneath, and passes a
sound one: a whole run of each smoke cell on the CPU (the look for a card
skipped), the program in fp32 so that a sound run reads next to nothing,
the limits those of the smoke cells (``conftest.SMOKE_LIMITS``).

The faults a serving cell on one card can have: a token altered where it is
produced (every served token moved to the next id), a decode step that
leaves its state unchanged, half of the batch left out (its answers copied
from the other half), and one decode stream's tokens altered among many
sound ones. The exchange between chips does not exist on one card."""

import copy
import time

import pytest
import torch

from yardstick import runner
from yardstick.program import Program

CPU = torch.device("cpu")


def _run(root, cell, monkeypatch=None, fault=None, limits=None):
    if fault is not None:
        fault(monkeypatch)
    c = runner.load_cell(cell, root=root)
    # a decode window long enough for several steps on a busy CPU: a state
    # left unchanged shows only from a request's second step on
    seconds = 2.0 if cell.endswith("decode") else 0.3
    result, _ = runner.run(c, 2**31 + 99, seconds, False, CPU, time.perf_counter(), limits)
    return result


def _next_token(monkeypatch):
    fwd, dec = Program.forward, Program.decode_step
    monkeypatch.setattr(Program, "forward", lambda self, *a: fwd(self, *a).roll(1, dims=-1))
    monkeypatch.setattr(Program, "decode_step", lambda self, *a: dec(self, *a).roll(1, dims=-1))


def _state_unchanged(monkeypatch):
    dec = Program.decode_step

    def step(self, params, cache, token, index, device):
        return dec(self, params, copy.deepcopy(cache), token, index, device)

    monkeypatch.setattr(Program, "decode_step", step)


def _half_batch(monkeypatch):
    fwd, dec = Program.forward, Program.decode_step

    def forward(self, params, tokens, device):  # one prompt a call: half of its positions
        out = fwd(self, params, tokens, device)
        h = out.shape[1] // 2
        out[:, -h:] = out[:, :h]
        return out

    def step(self, params, cache, token, index, device):
        out = dec(self, params, cache, token, index, device)
        h = out.shape[0] // 2
        out[h:] = out[:h]
        return out

    monkeypatch.setattr(Program, "forward", forward)
    monkeypatch.setattr(Program, "decode_step", step)


def _one_stream(monkeypatch):
    dec = Program.decode_step

    def step(self, params, cache, token, index, device):
        out = dec(self, params, cache, token, index, device)
        out[0] = out[0].roll(1, dims=-1)
        return out

    monkeypatch.setattr(Program, "decode_step", step)


CELLS = ["mixtral-prefill", "mixtral-decode", "jamba-prefill", "jamba-decode"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(smoke_root, cell):
    assert _run(smoke_root, cell)["correct"] is True


FAULTS = [(c, "next_token", _next_token) for c in CELLS]
FAULTS += [(c, "half_batch", _half_batch) for c in CELLS]
FAULTS += [(c, "state_unchanged", _state_unchanged) for c in CELLS if c.endswith("decode")]
FAULTS += [(c, "one_stream", _one_stream) for c in CELLS if c.endswith("decode")]


@pytest.mark.parametrize("cell,name,fault", FAULTS, ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(smoke_root, monkeypatch, cell, name, fault):
    result = _run(smoke_root, cell, monkeypatch, fault)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith("decode")])
def test_one_stream_at_fault_fails_the_worst_request(smoke_root, monkeypatch, cell):
    """One of the 8 streams served wrong tokens: the mean over all streams
    dilutes it, the worst stream's mean does not."""
    limits = {"compare": {"worst_request_gap": {"limit": 1e-3}}}
    result = _run(smoke_root, cell, monkeypatch, _one_stream, limits)
    assert result["correct"] is False
    assert result["compared"]["worst_request_gap"]["value"] >= 6 * result["checked"]["mean_gap"]
