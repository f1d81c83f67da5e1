"""MIG slice model, slot placement, and the 12 configurations of Fig. 1.

The paper partitions an A100-40GB into slices of compute size 1, 2, 3, 4 or 7
"slots" (SM fractions) with an associated memory size.  Only 12 configurations
(Fig. 1) are considered; configuration ids are 1-based to match the paper.

Partitions are *slot-placed*: every slice occupies a concrete start offset on
the device's slot grid, subject to NVIDIA's placement alignment (a 2g slice
starts on even offsets, 3g/4g on multiples of four, 1g anywhere).  Two
configurations that place an identical slice instance at the same offset share
that GPU instance, and a reconfiguration between them destroys/creates only
the non-shared instances (:func:`transition`).

The port's own copy of ``repro.core.slices``, with what the batched simulator
needs: the slice and partition types, the placement rule, the Fig. 1 table and
the transition plan. The free-slot geometry, the fragmentation ratio and the
A30 table belong to the fleet layer and are not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SliceType",
    "Partition",
    "TransitionPlan",
    "MIG_CONFIGS",
    "NUM_CONFIGS",
    "TOTAL_SLOTS",
    "ALL_SLICE_SIZES",
    "placement_alignment",
    "auto_starts",
    "transition",
]

TOTAL_SLOTS = 7
ALL_SLICE_SIZES = (1, 2, 3, 4, 7)


def placement_alignment(slots: int) -> int:
    """Start-offset alignment of a slice of ``slots`` compute units.

    1g slices may start anywhere, 2g slices on even offsets, 3g/4g (and the
    full-device 7g) on multiples of four.
    """
    if slots == 1:
        return 1
    if slots == 2:
        return 2
    return 4


def auto_starts(slot_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Left-packed placement of ordered slices on the slot grid.

    Walks the slices in order, placing each at the lowest aligned offset at
    or after the previous slice's end (config 5's second 3g slice skips
    offset 3 to its alignment boundary at 4).
    """
    starts: List[int] = []
    cursor = 0
    for slots in slot_sizes:
        a = placement_alignment(slots)
        start = ((cursor + a - 1) // a) * a
        starts.append(start)
        cursor = start + slots
    return tuple(starts)


@dataclasses.dataclass(frozen=True)
class SliceType:
    """A MIG slice type, e.g. ``2g.10gb`` -> SliceType(2, 10)."""

    slots: int  # compute size in "g" units (1,2,3,4,7)
    memory_gb: int

    def __post_init__(self) -> None:
        if self.slots not in ALL_SLICE_SIZES:
            raise ValueError(f"invalid slice size {self.slots}g")


S1_5 = SliceType(1, 5)
S1_10 = SliceType(1, 10)
S2_10 = SliceType(2, 10)
S3_20 = SliceType(3, 20)
S4_20 = SliceType(4, 20)
S7_40 = SliceType(7, 40)


@dataclasses.dataclass(frozen=True)
class Partition:
    """An ordered, slot-placed MIG partition (one row of Fig. 1).

    ``starts`` holds each slice's start offset on the slot grid; when omitted
    it is derived by :func:`auto_starts`.
    """

    config_id: int
    slices: Tuple[SliceType, ...]
    starts: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.starts is None:
            object.__setattr__(
                self, "starts", auto_starts(tuple(s.slots for s in self.slices))
            )
        elif len(self.starts) != len(self.slices):
            raise ValueError(
                f"config {self.config_id}: {len(self.starts)} starts for "
                f"{len(self.slices)} slices"
            )

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    def sorted_indices(self, descending: bool = False) -> List[int]:
        """Slice indices sorted by compute size ascending (or descending)."""
        return sorted(
            range(len(self.slices)),
            key=lambda i: self.slices[i].slots,
            reverse=descending,
        )

    def slice_instances(self) -> Tuple[Tuple[int, int, int], ...]:
        """Per-slice placement identity: ``(start, slots, memory_gb)``."""
        return tuple(
            (start, s.slots, s.memory_gb)
            for start, s in zip(self.starts, self.slices, strict=True)
        )

    def occupied_cells(self, index: int) -> range:
        """Grid cells ``[start, start+slots)`` occupied by slice ``index``."""
        return range(self.starts[index], self.starts[index] + self.slices[index].slots)


def _mk(config_id: int, *slices: SliceType) -> Partition:
    return Partition(config_id=config_id, slices=tuple(slices))


# Fig. 1 — the 12 configurations of an A100-40GB considered by the paper.
MIG_CONFIGS: Dict[int, Partition] = {
    1: _mk(1, S7_40),
    2: _mk(2, S4_20, S3_20),
    3: _mk(3, S4_20, S2_10, S1_10),
    4: _mk(4, S4_20, S1_5, S1_5, S1_10),
    5: _mk(5, S3_20, S3_20),  # note: 1-slot "hole" (6 of 7 slots used)
    6: _mk(6, S2_10, S2_10, S3_20),
    7: _mk(7, S2_10, S1_5, S1_5, S3_20),
    8: _mk(8, S1_5, S1_5, S1_5, S1_5, S3_20),
    9: _mk(9, S2_10, S2_10, S2_10, S1_10),
    10: _mk(10, S2_10, S2_10, S1_5, S1_5, S1_10),
    11: _mk(11, S2_10, S1_5, S1_5, S1_5, S1_5, S1_10),
    12: _mk(12, S1_5, S1_5, S1_5, S1_5, S1_5, S1_5, S1_10),
}

NUM_CONFIGS = len(MIG_CONFIGS)


@dataclasses.dataclass(frozen=True)
class TransitionPlan:
    """What a reconfiguration ``old -> new`` does to placed slice instances.

    A slice instance *survives* when the identical ``(start, slots,
    memory_gb)`` placement exists in both configurations; everything else is
    destroyed (old indices) or created (new indices).  ``stalled_slots``
    counts the grid cells touched by the rebuild.
    """

    old_config_id: int
    new_config_id: int
    surviving: Tuple[Tuple[int, int], ...]  # (old index, new index) pairs
    destroyed: Tuple[int, ...]  # old slice indices torn down
    created: Tuple[int, ...]  # new slice indices built
    stalled_slots: int

    @property
    def survivor_map(self) -> Dict[int, int]:
        """``surviving`` as an old-index -> new-index dict."""
        return dict(self.surviving)


def transition(old: Partition, new: Partition) -> TransitionPlan:
    """Plan the partial reconfiguration ``old -> new``.

    Matches placed slice instances by identity (same start offset, compute
    width and memory): matches survive with their jobs, the rest are
    destroyed/created.
    """
    old_by_key = {key: i for i, key in enumerate(old.slice_instances())}
    surviving: List[Tuple[int, int]] = []
    created: List[int] = []
    for j, key in enumerate(new.slice_instances()):
        i = old_by_key.get(key)
        if i is not None:
            surviving.append((i, j))
        else:
            created.append(j)
    matched_old = {i for i, _ in surviving}
    destroyed = tuple(i for i in range(old.num_slices) if i not in matched_old)
    cells = set()
    for i in destroyed:
        cells.update(old.occupied_cells(i))
    for j in created:
        cells.update(new.occupied_cells(j))
    return TransitionPlan(
        old_config_id=old.config_id,
        new_config_id=new.config_id,
        surviving=tuple(surviving),
        destroyed=destroyed,
        created=tuple(created),
        stalled_slots=len(cells),
    )
