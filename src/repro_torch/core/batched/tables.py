"""Padded device tables for the batched backend (numpy, jax-free).

The batched simulator cannot chase Python objects at trace time, so this
module flattens the slot-placement model of :mod:`repro_torch.core.slices` into
dense integer tables, padded to the device's maximum slice count ``S``:

* ``slice_slots[c, s]`` — compute size of slice ``s`` under config index
  ``c`` (0 beyond ``num_slices[c]``);
* ``slice_rank[c, r]`` — the slice index holding fastest-first rank ``r``,
  replicating :meth:`repro_torch.core.slices.Partition.sorted_indices` including
  its stable tie-break (−1 beyond ``num_slices[c]``);
* ``old_to_new[a, b, s]`` — where slice ``s`` of config index ``a`` lands
  after a *partial* repartition to config index ``b`` (−1 = destroyed),
  computed by :func:`repro_torch.core.slices.transition` for every config pair.
  The drain model is the all-(−1) degenerate case and needs no table.

The port's own copy of ``repro.core.batched.tables`` (plain numpy);
:mod:`repro_torch.core.batched.backend` turns the tables into tensors once
per simulation.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.power import A100_250W, PowerModel
from repro_torch.core.simulator import REPARTITION_PENALTY_MIN
from repro_torch.core.slices import MIG_CONFIGS, Partition, transition

__all__ = ["DeviceTables", "build_tables"]


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Dense, padded view of one device's partition table + power curve.

    Shapes use ``C`` = number of configurations, ``S`` = max slices of any
    configuration, ``K`` = ``max_slots + 1`` (busy-slot levels 0..max_slots).
    All arrays are read-only numpy; see the module docstring for semantics.
    """

    config_ids: np.ndarray  # (C,) int32, ascending config ids
    num_slices: np.ndarray  # (C,) int32
    slice_slots: np.ndarray  # (C, S) int32, 0-padded
    slice_rank: np.ndarray  # (C, S) int32, fastest-first, -1-padded
    old_to_new: np.ndarray  # (C, C, S) int32, -1 = destroyed
    watts_by_busy: np.ndarray  # (K,) float32
    max_slots: int
    penalty_min: float

    @property
    def num_configs(self) -> int:
        """``C`` — how many configurations the device exposes."""
        return int(self.config_ids.shape[0])

    @property
    def max_slices(self) -> int:
        """``S`` — the padded per-config slice capacity."""
        return int(self.slice_slots.shape[1])

    def index_of(self, config_id: int) -> int:
        """Dense config index for a 1-based configuration id."""
        idx = int(np.searchsorted(self.config_ids, config_id))
        if idx >= len(self.config_ids) or self.config_ids[idx] != config_id:
            raise KeyError(
                f"config {config_id} not in table (valid ids "
                f"{self.config_ids.tolist()})"
            )
        return idx


def build_tables(
    configs: Optional[Mapping[int, Partition]] = None,
    power: PowerModel = A100_250W,
    penalty_min: float = REPARTITION_PENALTY_MIN,
) -> DeviceTables:
    """Flatten a partition table + power model into :class:`DeviceTables`.

    ``configs`` defaults to the paper's A100 Fig. 1 table.  The power curve
    must cover busy levels up to the largest configuration footprint (the
    same invariant :class:`repro_torch.core.power.PowerModel` enforces on lookup).
    """
    table = dict(MIG_CONFIGS if configs is None else configs)
    ids = sorted(table)
    parts: Sequence[Partition] = [table[i] for i in ids]
    C = len(parts)
    S = max(p.num_slices for p in parts)
    max_slots = max(p.starts[i] + p.slices[i].slots
                    for p in parts for i in range(p.num_slices))

    num_slices = np.array([p.num_slices for p in parts], dtype=np.int32)
    slice_slots = np.zeros((C, S), dtype=np.int32)
    slice_rank = np.full((C, S), -1, dtype=np.int32)
    for c, p in enumerate(parts):
        for s, st in enumerate(p.slices):
            slice_slots[c, s] = st.slots
        ranked = p.sorted_indices(descending=True)
        slice_rank[c, : len(ranked)] = np.array(ranked, dtype=np.int32)

    old_to_new = np.full((C, C, S), -1, dtype=np.int32)
    for a, pa in enumerate(parts):
        for b, pb in enumerate(parts):
            surv = transition(pa, pb).survivor_map
            for old_idx, new_idx in surv.items():
                old_to_new[a, b, old_idx] = new_idx

    watts = np.asarray(
        [power.power_watts(float(k)) for k in range(max_slots + 1)],
        dtype=np.float32,
    )

    for arr in (num_slices, slice_slots, slice_rank, old_to_new, watts):
        arr.setflags(write=False)
    config_ids = np.asarray(ids, dtype=np.int32)
    config_ids.setflags(write=False)
    return DeviceTables(
        config_ids=config_ids,
        num_slices=num_slices,
        slice_slots=slice_slots,
        slice_rank=slice_rank,
        old_to_new=old_to_new,
        watts_by_busy=watts,
        max_slots=int(max_slots),
        penalty_min=float(penalty_min),
    )
