"""Atomic, rotated engine checkpoints for the scheduler service.

A checkpoint is an opaque pickle blob (built by
:meth:`repro_torch.service.SchedulerService.checkpoint`) named by the op
sequence number it covers: ``ckpt-000000000042.pkl`` means "service state
after applying WAL op 42".  Writes are atomic (tmp + fsync +
``os.replace``), so the store never holds a half-written snapshot; the
newest ``keep`` checkpoints are retained and older ones pruned, bounding
disk usage over long runs while keeping one fallback should the newest
blob fail to unpickle after a code change.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Tuple, Union

__all__ = ["CheckpointStore"]

_NAME = re.compile(r"^ckpt-(\d{12})\.pkl$")


class CheckpointStore:
    """Directory of ``ckpt-<seq>.pkl`` blobs; see module docstring."""

    def __init__(self, directory: Union[str, Path], keep: int = 2) -> None:
        if keep < 1:
            raise ValueError(f"must keep at least one checkpoint, got keep={keep}")
        self.directory = Path(directory)
        self.keep = keep

    def _entries(self) -> List[Tuple[int, Path]]:
        out = []
        for p in self.directory.iterdir():
            m = _NAME.match(p.name)
            if m:
                out.append((int(m.group(1)), p))
        out.sort()
        return out

    def save(self, blob: bytes, seq: int) -> Path:
        """Atomically write the blob as the checkpoint covering op ``seq``."""
        path = self.directory / f"ckpt-{seq:012d}.pkl"
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        for _, old in self._entries()[: -self.keep]:
            old.unlink()
        return path

    def latest(self) -> Optional[Tuple[int, bytes]]:
        """The newest checkpoint as ``(seq, blob)``, or None when empty."""
        entries = self._entries()
        if not entries:
            return None
        seq, path = entries[-1]
        return seq, path.read_bytes()
