"""Spans and counters of the model step, for a torch profiler.

The port's one instrument of its own besides the kernels' ``LAUNCHES``
counts. It costs a boolean check a call unless a torch profiler is
recording (``torch.autograd._profiler_enabled()``); then:

* :func:`span` is a ``torch.profiler.record_function``, so each span lands
  in the profiler's trace beside the device operations, on the same clock
  (``user_annotation`` rows of the exported Chrome trace);
* :func:`record` keeps a reference to values the program has already
  computed (no copy, no device work), and :func:`samples` hands them back
  as host values.

The samples restart with each profiled stretch: the first span or record
that finds a profiler recording after one that found none drops what the
last stretch kept. A reader sees the latest stretch only; two profiled
stretches with no call of the program between them read as one. A layer
that ``torch.utils.checkpoint`` runs again in the backward pass enters its
spans and records again.

Spans (:mod:`repro_torch.models.transformer`, :mod:`repro_torch.models.moe`):
``rt.forward``, ``rt.decode_step``; ``rt.layer.<kind>`` around one layer
with the indexing of its parameters and cache; ``rt.attention``,
``rt.mamba``, ``rt.moe``, ``rt.mlp``, ``rt.logits``; inside the MoE
``rt.moe.route``, ``rt.moe.dispatch``, ``rt.moe.experts``,
``rt.moe.combine``. Counters: ``rt.moe.copies``, one sample a MoE layer
call, ``(counts, capacity)``: the copies routed to each expert and the
copies an expert keeps at most; ``rt.attention.decode``
(:mod:`repro_torch.kernels.decode_attention`), one sample a K5 call,
``(fill_len, splits)``: the slots attended and the splits of the cache.

Run any ``torch.profiler.profile`` around serving to get both; nothing is
kept otherwise.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["span", "record", "samples"]

_OFF = contextlib.nullcontext()  # stateless, so one instance serves every nesting
_profiling = torch.autograd._profiler_enabled


class _Stretch:
    """What :func:`record` kept in the latest profiled stretch."""

    def __init__(self) -> None:
        self.on = False
        self.kept: Dict[str, List[Tuple[Any, ...]]] = {}

    def enter(self) -> None:
        """A profiler records: a new stretch if none recorded at the last look."""
        if not self.on:
            self.on = True
            self.kept = {}


_STRETCH = _Stretch()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a no-op context."""
    if _profiling():
        _STRETCH.enter()
        return torch.profiler.record_function(name)
    _STRETCH.on = False
    return _OFF


def record(name: str, *values: Any) -> None:
    """Keep ``values`` (tensors by reference) under ``name`` while a profiler records."""
    if _profiling():
        _STRETCH.enter()
        _STRETCH.kept.setdefault(name, []).append(values)
    else:
        _STRETCH.on = False


def samples(name: str) -> List[Tuple[Any, ...]]:
    """The latest profiled stretch's samples of ``name``, in the order they
    were recorded, each tensor as a list, after one synchronise of the card."""
    kept = _STRETCH.kept.get(name, [])
    if any(isinstance(v, torch.Tensor) and v.is_cuda for s in kept for v in s):
        torch.cuda.synchronize()
    return [tuple(v.tolist() if isinstance(v, torch.Tensor) else v for v in s) for s in kept]
