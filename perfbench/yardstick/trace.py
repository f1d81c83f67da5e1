"""The device trace of a run's traced slice: torch.profiler (CUPTI) over the
slice, exported as a Chrome trace and read back here.

What the readers under ``perfbench/metrics`` get from it: every device
operation (kernel, copy, fill) with its name, start and length; the union of
their intervals (the device's busy time); and the idle gaps between them,
each put down to the innermost host operation that was running at its middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Trace", "Tracer", "read_trace", "merge"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Trace:
    """One traced slice. Times in seconds; ``ops`` are (name, start, length)."""

    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float  # the slice on the host's clock: profiler start to its last synchronise

    def device_seconds(self, names: Sequence[str]) -> float:
        """Summed device time of the operations whose name holds one of ``names``."""
        return sum(d for n, _, d in self.ops if any(k in n for k in names))

    def count(self, names: Sequence[str]) -> int:
        return sum(1 for n, _, _ in self.ops if any(k in n for k in names))

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in merge((s, s + d) for _, s, d in self.ops))

    def top_ops(self) -> List[List]:
        total: Dict[str, float] = collections.defaultdict(float)
        for n, _, d in self.ops:
            total[n] += d
        return [[n[:160], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle time between device operations, summed by the innermost host
        operation that ran at each gap's middle."""
        busy = merge((s, s + d) for _, s, d in self.ops)
        host = sorted(self.host, key=lambda e: e[1])
        total: Dict[str, float] = collections.defaultdict(float)
        active: List[Tuple[str, float, float]] = []
        nxt = 0
        for (_, a), (b, _) in zip(busy, busy[1:]):  # gaps in time order: one sweep
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [e for e in active if e[1] + e[2] >= mid]
            # the innermost of the nested host operations is the one that started last
            name = max(active, key=lambda e: e[1])[0] if active else "host, no operation traced"
            total[name[:160]] += b - a
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def merge(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(path: str, window_s: float) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        row = (str(e.get("name", "")), float(e["ts"]) / 1e6, float(e.get("dur", 0.0)) / 1e6)
        if e.get("cat") in DEVICE_CATS:
            ops.append(row)
        elif e.get("cat") in HOST_CATS:
            host.append(row)
    return Trace(ops=ops, host=host, window_s=window_s)


class Tracer:
    """torch.profiler over a slice: :meth:`start`, then :meth:`stop` after a
    synchronise; :meth:`read` exports the trace to a temporary file (under
    ``TMPDIR``), reads it and deletes it."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0: Optional[float] = None
        self.window_s = 0.0

    def start(self, now: float) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = now

    def mark_end(self, now: float) -> None:
        """The slice's last synchronise has returned."""
        self.window_s = now - self.t0

    def stop(self) -> None:
        self.prof.stop()

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return read_trace(path, self.window_s)
        finally:
            os.remove(path)
