"""Distributed runtime of the port (counterpart of ``repro.distributed``):
sharding rules, hints, the model's layers on a mesh, gradient compression,
the train and serve steps and fault tolerance. Meshes themselves are built
in :mod:`repro_torch.launch.mesh`.

The step builders are loaded on first use: :mod:`repro_torch.distributed.step`
imports the models, whose layers import :mod:`~repro_torch.distributed.parallel`
from this package.
"""

import importlib

from repro_torch.distributed.sharding import (
    DP_AXES,
    batch_shardings,
    cache_shardings,
    param_shardings,
)

_STEP = ("make_train_step", "make_serve_step", "make_prefill_step", "train_state",
         "from_train_state")

__all__ = ["param_shardings", "batch_shardings", "cache_shardings", "DP_AXES", *_STEP]


def __getattr__(name: str):
    if name in _STEP:
        return getattr(importlib.import_module("repro_torch.distributed.step"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
