"""The port's serving driver and device policy (repro_torch.launch.serve, repro_torch.device)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models import forward, init_cache, init_params


def test_serve_smoke_on_cpu():
    tps = serve("gemma3_1b", smoke=True, steps=4, device="cpu", verbose=False)
    assert np.isfinite(tps) and tps > 0


def test_serve_rejects_a_mesh_and_too_few_steps():
    # the production mesh needs a world of 256 ranks; this process is one
    with pytest.raises(ValueError, match="256 ranks"):
        serve("gemma3_1b", production_mesh=True, device="cpu")
    with pytest.raises(ValueError, match="steps"):
        serve("gemma3_1b", steps=1, device="cpu")


def test_resolve_device_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_no_cpu_fallback_without_cuda(monkeypatch):
    """With no card, every entry point raises unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = smoke_config("gemma3_1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("gemma3_1b", steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward(cfg, params, {"tokens": np.zeros((1, 4), np.int64)})


def test_forward_rejects_params_on_another_device():
    cfg = smoke_config("gemma3_1b")
    params = init_params(cfg, device="cpu")
    params = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="params lie on meta"):
        forward(cfg, params, {"tokens": np.zeros((1, 4), np.int64)}, device="cpu")
