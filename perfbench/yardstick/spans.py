"""What the program's own spans and counters say about a traced slice.

The program opens named spans while a profiler records (``record_function``;
``user_annotation`` rows among the trace's host rows, ``Trace.host``), and
keeps counter samples of the slice in its own process. Here:

* an idle gap is a gap between the device's busy intervals (the union of
  ``Trace.ops``); it lies in a span when its middle lies inside a row of that
  span's name (names compared whole);
* :func:`idle_share`: the idle gaps in the named spans over the slice's wall
  time, in %;
* :func:`idle_share_outside`: the slice's idle time that no gap in the named
  spans holds (so also the slice's edges before its first device operation
  and after its last), over its wall time, in %. Where the spans of
  :func:`idle_share` tile the named spans, the two add up to the slice's
  whole idle share;
* :func:`kept_rows`: per traced prompt or step and MoE layer, the copies the
  capacity kept and the experts that kept any, from the program's samples of
  (copies each expert got, capacity).

Each returns None where the trace holds no device operation or no span of
the names, or where the samples do not match the slice. Nothing here names a
cell, a configuration or a metric.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence, Tuple

from yardstick.trace import Trace, merge

__all__ = ["idle_in", "idle_share", "idle_share_outside", "kept_rows"]


def idle_in(trace: Trace, names: Iterable[str]) -> Optional[float]:
    """Seconds of the idle gaps whose middle lies inside a span of ``names``;
    None where the trace holds no such span."""
    names = set(names)
    inside = merge((s, s + d) for n, s, d in trace.host if n in names)
    if not inside:
        return None
    starts = [a for a, _ in inside]
    busy = merge((s, s + d) for _, s, d in trace.ops)
    total = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        if i >= 0 and (a + b) / 2 <= inside[i][1]:
            total += b - a
    return total


def _usable(ctx) -> bool:
    return ctx.trace.window_s > 0 and bool(ctx.trace.ops)


def idle_share(ctx, names: Sequence[str]) -> Optional[float]:
    """The slice's idle gaps inside the spans ``names``, in % of its wall time."""
    idle = idle_in(ctx.trace, names) if _usable(ctx) else None
    return None if idle is None else 100.0 * idle / ctx.trace.window_s


def idle_share_outside(ctx, names: Sequence[str]) -> Optional[float]:
    """The slice's idle time outside the spans ``names`` (its edges included),
    in % of its wall time."""
    idle = idle_in(ctx.trace, names) if _usable(ctx) else None
    if idle is None:
        return None
    return 100.0 * (ctx.trace.window_s - ctx.trace.busy_s - idle) / ctx.trace.window_s


def kept_rows(ctx, samples: List[Tuple[List[int], int]], name: str
              ) -> Optional[List[List[Tuple[int, int]]]]:
    """For each traced prompt or step, for each MoE layer: (copies kept,
    experts that kept any), as ``ctx.routed`` holds them, from the slice's
    samples of (copies each expert got, capacity) in the order the layers
    ran. None, with a note under ``name``, where their number is not one a
    MoE layer of each traced prompt or step."""
    want = len(ctx.traced) * ctx.shape.moe_layers
    if not samples or len(samples) != want:
        ctx.notes.append(f"{name}: {len(samples)} samples of the program's counter, "
                         f"not {len(ctx.traced)} x {ctx.shape.moe_layers}")
        return None
    rows = [(sum(min(c, cap) for c in counts), sum(c > 0 for c in counts))
            for counts, cap in samples]
    n = ctx.shape.moe_layers
    return [rows[i : i + n] for i in range(0, want, n)]
