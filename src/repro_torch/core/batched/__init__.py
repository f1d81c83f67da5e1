"""Batched fixed-timestep MIG simulation on one device, in torch.

The port of ``repro.core.batched``: many (seed × scenario × config) rollouts
advance lock-step as tensors with the batch on their first axis.

Public surface:

* :func:`build_tables` / :class:`DeviceTables` — the slot-placement model
  flattened to padded arrays (numpy);
* :class:`BatchedJobs` / :class:`BatchedResult` — padded batch containers
  and the SimResult-compatible aggregates;
* :func:`compile_policy` / :class:`BatchedPolicy` — policies compiled to
  per-rollout target arrays (static/nomig/daynight), :func:`held_policy`;
* :func:`simulate_batch` — run a batch to completion (on the CUDA card
  unless ``device="cpu"``).

The vectorized RL environment (``BatchedRepartitionEnv``) is not ported yet.
"""

from repro_torch.core.batched.backend import (
    DEFAULT_CHUNK_STEPS,
    DEFAULT_DT_MIN,
    RolloutState,
    simulate_batch,
)
from repro_torch.core.batched.policies import (
    BatchedPolicy,
    UnsupportedPolicyError,
    compile_policy,
    held_policy,
)
from repro_torch.core.batched.state import PAD_MULTIPLE, BatchedJobs, BatchedResult
from repro_torch.core.batched.tables import DeviceTables, build_tables

__all__ = [
    "DEFAULT_CHUNK_STEPS",
    "DEFAULT_DT_MIN",
    "PAD_MULTIPLE",
    "BatchedJobs",
    "BatchedPolicy",
    "BatchedResult",
    "DeviceTables",
    "RolloutState",
    "UnsupportedPolicyError",
    "build_tables",
    "compile_policy",
    "held_policy",
    "simulate_batch",
]
