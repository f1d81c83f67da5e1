"""MIG slice model, slot placement, and the 12 configurations of Fig. 1.

The paper partitions an A100-40GB into slices of compute size 1, 2, 3, 4 or 7
"slots" (SM fractions) with an associated memory size.  Only 12 configurations
(Fig. 1) are considered; configuration ids are 1-based to match the paper.

Partitions are *slot-placed*: every slice occupies a concrete start offset on
the device's slot grid, subject to NVIDIA's placement alignment (a 2g slice
starts on even offsets, 3g/4g on multiples of four, 1g anywhere).  Placement
is what makes repartitioning *partial*: two configurations that place an
identical slice instance at the same offset share that GPU instance, and a
reconfiguration between them destroys/creates only the non-shared instances
(:func:`transition`) — jobs on shared instances keep running (DESIGN.md §7).

The port's own copy of ``repro.core.slices``: the slice and partition types,
the placement rule, the Fig. 1 table, the A30 table of the fleet layer, the
transition plan, the free-slot geometry the event engine's snapshots read,
the fleet-wide fragmentation ratio, and the table check.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SliceType",
    "Partition",
    "TransitionPlan",
    "MIG_CONFIGS",
    "A30_CONFIGS",
    "NUM_CONFIGS",
    "TOTAL_SLOTS",
    "ALL_SLICE_SIZES",
    "config",
    "config_ids",
    "placement_alignment",
    "auto_starts",
    "transition",
    "validate_config_table",
    "FreeSlotGeometry",
    "free_slot_geometry",
    "fleet_fragmentation",
    "table_slice_sizes",
]

TOTAL_SLOTS = 7
ALL_SLICE_SIZES = (1, 2, 3, 4, 7)


def placement_alignment(slots: int) -> int:
    """Start-offset alignment of a slice of ``slots`` compute units.

    Encodes NVIDIA's MIG placement grid: 1g slices may start anywhere, 2g
    slices on even offsets, 3g/4g (and the full-device 7g) on multiples of
    four.  On the A100's 7-slot grid this yields exactly the documented
    placements (1g: 0-6, 2g: {0,2,4}, 3g: {0,4}, 4g: {0}, 7g: {0}); the
    same rule reproduces the A30's 4-slot grid (2g: {0,2}, 4g: {0}).
    """
    if slots == 1:
        return 1
    if slots == 2:
        return 2
    return 4


def auto_starts(slot_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Left-packed placement of ordered slices on the slot grid.

    Walks the slices in order, placing each at the lowest aligned offset at
    or after the previous slice's end.  This reproduces the canonical NVIDIA
    layout for every Fig. 1 configuration (including config 5's 1-slot hole:
    the second 3g slice skips offset 3 to its alignment boundary at 4).
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

    @property
    def name(self) -> str:
        return f"{self.slots}g.{self.memory_gb}gb"

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        return self.name


# Shorthand constructors for the A100-40GB slice types used in Fig. 1.
S1_5 = SliceType(1, 5)
S1_10 = SliceType(1, 10)
S2_10 = SliceType(2, 10)
S3_20 = SliceType(3, 20)
S4_20 = SliceType(4, 20)
S7_40 = SliceType(7, 40)


@dataclasses.dataclass(frozen=True)
class Partition:
    """An ordered, slot-placed MIG partition (one row of Fig. 1).

    ``starts`` holds each slice's start offset on the device's slot grid;
    when omitted it is derived by :func:`auto_starts` (left-packed at NVIDIA
    placement alignment), which reproduces the canonical layout of every
    Fig. 1 configuration.
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

    @property
    def total_slots(self) -> int:
        return sum(s.slots for s in self.slices)

    @property
    def total_memory_gb(self) -> int:
        return sum(s.memory_gb for s in self.slices)

    def slot_sizes(self) -> Tuple[int, ...]:
        return tuple(s.slots for s in self.slices)

    def fastest_slice_index(self) -> int:
        """Index of the largest-compute slice (ties -> first)."""
        return max(range(len(self.slices)), key=lambda i: self.slices[i].slots)

    def slowest_slice_index(self) -> int:
        return min(range(len(self.slices)), key=lambda i: self.slices[i].slots)

    def sorted_indices(self, descending: bool = False) -> List[int]:
        """Slice indices sorted by compute size ascending (or descending)."""
        return sorted(
            range(len(self.slices)),
            key=lambda i: self.slices[i].slots,
            reverse=descending,
        )

    def slice_instances(self) -> Tuple[Tuple[int, int, int], ...]:
        """Per-slice placement identity: ``(start, slots, memory_gb)``.

        Two configurations share a physical GPU instance exactly when both
        contain the same identity triple — the survival criterion of
        :func:`transition`.
        """
        return tuple(
            (start, s.slots, s.memory_gb)
            for start, s in zip(self.starts, self.slices, strict=True)
        )

    def occupied_cells(self, index: int) -> range:
        """Grid cells ``[start, start+slots)`` occupied by slice ``index``."""
        return range(self.starts[index], self.starts[index] + self.slices[index].slots)

    def __str__(self) -> str:  # pragma: no cover - repr sugar
        body = " + ".join(
            f"{s.name}@{start}" for start, s in zip(self.starts, self.slices, strict=True)
        )
        return f"cfg{self.config_id}[{body}]"


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

# ----------------------------------------------------------------------
# A30-class device (24 GB, 4 compute slots): the second fleet profile.
# NVIDIA's A30 MIG geometry: 1g.6gb, 2g.12gb, 4g.24gb; four valid layouts.

A30_S1_6 = SliceType(1, 6)
A30_S2_12 = SliceType(2, 12)
A30_S4_24 = SliceType(4, 24)

A30_CONFIGS: Dict[int, Partition] = {
    1: _mk(1, A30_S4_24),
    2: _mk(2, A30_S2_12, A30_S2_12),
    3: _mk(3, A30_S2_12, A30_S1_6, A30_S1_6),
    4: _mk(4, A30_S1_6, A30_S1_6, A30_S1_6, A30_S1_6),
}


def config(config_id: int) -> Partition:
    """Return the partition for a 1-based Fig. 1 configuration id."""
    try:
        return MIG_CONFIGS[config_id]
    except KeyError as e:  # pragma: no cover - defensive
        raise KeyError(
            f"unknown MIG config {config_id}; valid ids {sorted(MIG_CONFIGS)}"
        ) from e


def config_ids() -> Sequence[int]:
    return tuple(sorted(MIG_CONFIGS))


@dataclasses.dataclass(frozen=True)
class TransitionPlan:
    """What a reconfiguration ``old -> new`` does to placed slice instances.

    A slice instance *survives* when the identical ``(start, slots,
    memory_gb)`` placement exists in both configurations — the physical GPU
    instance is untouched and jobs on it keep running.  Everything else is
    destroyed (old indices) or created (new indices) and stalls for the
    §IV-D-3 repartition penalty.

    ``surviving`` maps old slice index -> new slice index (survivor identity
    across the index renumbering).  ``stalled_slots`` counts the grid cells
    touched by the rebuild (cells of destroyed ∪ cells of created) — the
    stall footprint the simulator charges and telemetry reports.
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

    @property
    def full_turnover(self) -> bool:
        """True when no slice instance survives (drain-equivalent switch)."""
        return not self.surviving


def transition(old: Partition, new: Partition) -> TransitionPlan:
    """Plan the partial reconfiguration ``old -> new`` (DESIGN.md §7).

    Matches placed slice instances by identity (same start offset, compute
    width, and memory): matches survive with their jobs, the rest are
    destroyed/created.  ``transition(p, p)`` is the identity plan (everything
    survives, nothing stalls); a plan with no survivors is exactly the
    legacy full-drain model.
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


# ----------------------------------------------------------------------
# Free-slot geometry and the fragmentation ratio (DESIGN.md §9).
#
# A serving fleet cares not about *how many* slots are free but about the
# largest instance the free region can still host: seven free slots split
# 1+2+1+2+1 across placement holes cannot place a 4g slice.  Following the
# fragmentation-aware MIG literature we measure this as a ratio in [0, 1]:
# 0 when the free capacity is fully usable (or there is none), approaching
# 1 as alignment holes shred it.


@dataclasses.dataclass(frozen=True)
class FreeSlotGeometry:
    """The free region of a slot grid, as maximal contiguous runs.

    A grid cell is *free* when no occupied slice covers it — cells of
    unoccupied slice instances count as free (a repartition may rebuild
    them), as do placement holes outside every slice (config 5's slot 3).

    ``slice_sizes`` is the device's placeable instance vocabulary (an A30
    has no 3g slice); it bounds :attr:`max_placeable_slots` and therefore
    the fragmentation ratio.
    """

    total_slots: int
    runs: Tuple[Tuple[int, int], ...]  # maximal free runs as (start, length)
    slice_sizes: Tuple[int, ...] = ALL_SLICE_SIZES

    @property
    def free_slots(self) -> int:
        """Total free grid cells (sum of run lengths)."""
        return sum(length for _, length in self.runs)

    def placeable_starts(self, slots: int) -> Tuple[int, ...]:
        """Aligned start offsets where a ``slots``-wide instance fits."""
        a = placement_alignment(slots)
        out: List[int] = []
        for start, length in self.runs:
            s = ((start + a - 1) // a) * a
            while s + slots <= start + length:
                out.append(s)
                s += a
        return tuple(out)

    @property
    def max_placeable_slots(self) -> int:
        """Largest placeable instance (0 when nothing fits anywhere)."""
        best = 0
        for slots in self.slice_sizes:
            if slots > best and self.placeable_starts(slots):
                best = slots
        return best

    @property
    def fragmentation(self) -> float:
        """``1 - max_placeable / free`` in [0, 1]; 0 when nothing is free.

        0 means the free capacity is fully usable as one instance (an empty
        or a fully-occupied device both score 0); it grows as placement
        alignment shreds the free cells into runs too small or misaligned
        for the larger slice classes.
        """
        free = self.free_slots
        if free == 0:
            return 0.0
        return 1.0 - self.max_placeable_slots / free


def table_slice_sizes(configs: Dict[int, Partition]) -> Tuple[int, ...]:
    """Sorted distinct slice widths a device's partition table can place."""
    return tuple(sorted({s.slots for p in configs.values() for s in p.slices}))


def free_slot_geometry(
    partition: Partition,
    occupied_slices: Sequence[int],
    *,
    total_slots: int,
    slice_sizes: Optional[Sequence[int]] = None,
) -> FreeSlotGeometry:
    """Free-slot geometry of ``partition`` with the given slices occupied.

    ``occupied_slices`` are indices into ``partition.slices`` (an invalid
    index raises).  Free cells are everything else on the ``total_slots``
    grid: unoccupied slice instances and placement holes alike.
    """
    busy = set()
    for i in occupied_slices:
        if not 0 <= i < partition.num_slices:
            raise IndexError(
                f"occupied slice index {i} out of range for {partition}"
            )
        busy.update(partition.occupied_cells(i))
    sizes = (
        tuple(sorted(slice_sizes))
        if slice_sizes is not None
        else tuple(s for s in ALL_SLICE_SIZES if s <= total_slots)
    )
    runs: List[Tuple[int, int]] = []
    run_start: Optional[int] = None
    for cell in range(total_slots):
        if cell in busy:
            if run_start is not None:
                runs.append((run_start, cell - run_start))
                run_start = None
        elif run_start is None:
            run_start = cell
    if run_start is not None:
        runs.append((run_start, total_slots - run_start))
    return FreeSlotGeometry(
        total_slots=total_slots, runs=tuple(runs), slice_sizes=sizes
    )


def fleet_fragmentation(geometries: Sequence[FreeSlotGeometry]) -> float:
    """Free-capacity-weighted fleet fragmentation ratio in [0, 1].

    ``1 - sum(max placeable) / sum(free)`` over the fleet — equivalently
    the per-device ratios weighted by each device's free slots, so a large
    idle device dominates a shredded small one.  0 when nothing is free.
    """
    free = sum(g.free_slots for g in geometries)
    if free == 0:
        return 0.0
    placeable = sum(g.max_placeable_slots for g in geometries)
    return 1.0 - placeable / free


def validate_config_table(
    configs: Dict[int, Partition],
    max_slots: int,
    max_memory_gb: int,
    max_1g10_slices: int | None = None,
    name: str | None = None,
) -> None:
    """Sanity-check a device's partition table (invoked at import, cheap).

    Besides the capacity checks, verifies every configuration is *placement
    valid* on the device's slot grid: starts respect the NVIDIA alignment
    rule (:func:`placement_alignment`), slices stay inside the grid, and no
    two slices overlap — the preconditions the :func:`transition` instance
    matching relies on.

    ``name`` identifies the device profile (or table) in every error so a
    fleet-config failure points at the offending hardware entry, not just a
    bare config id that is ambiguous across per-profile tables.
    """
    where = f"{name} table, " if name else ""
    for cid, part in configs.items():
        ctx = f"{where}config {cid}"
        if part.config_id != cid:
            raise AssertionError(f"{ctx}: config id mismatch ({part.config_id})")
        if part.total_slots > max_slots:
            raise AssertionError(f"{ctx} exceeds {max_slots} slots")
        if part.total_memory_gb > max_memory_gb:
            raise AssertionError(f"{ctx} exceeds {max_memory_gb}GB")
        if max_1g10_slices is not None:
            n_1g10 = sum(1 for s in part.slices if s == S1_10)
            if n_1g10 > max_1g10_slices:
                raise AssertionError(f"{ctx} has {n_1g10} 1g.10gb slices")
        occupied: set = set()
        for i, (start, s) in enumerate(zip(part.starts, part.slices, strict=True)):
            if start % placement_alignment(s.slots) != 0:
                raise AssertionError(
                    f"{ctx} slice {i} ({s.name}) starts at {start}, "
                    f"violating the {placement_alignment(s.slots)}-slot "
                    "placement alignment"
                )
            cells = set(part.occupied_cells(i))
            if start < 0 or start + s.slots > max_slots:
                raise AssertionError(
                    f"{ctx} slice {i} ({s.name}@{start}) leaves the "
                    f"{max_slots}-slot grid"
                )
            if occupied & cells:
                raise AssertionError(
                    f"{ctx} slice {i} ({s.name}@{start}) overlaps "
                    "another slice"
                )
            occupied |= cells


# A100 Fig. 1 table: at most one 1g.10gb slice per configuration (paper §III-A)
validate_config_table(MIG_CONFIGS, TOTAL_SLOTS, 40, max_1g10_slices=1, name="A100 Fig. 1")
validate_config_table(A30_CONFIGS, 4, 24, name="A30")
