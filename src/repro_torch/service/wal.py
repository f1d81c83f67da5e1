"""Append-only write-ahead log of service operations (docs/SERVICE.md).

One JSON object per line (see :mod:`repro_torch.service.records` for the schema).
The log is the service's durability primitive:

* :meth:`WriteAheadLog.append` writes + flushes one record (``fsync``
  optionally, per the service config) **before** the op is acknowledged to
  the client — an acked op survives a crash;
* :func:`read_wal` tolerates a *torn tail*: a crash mid-``write`` can leave
  a truncated final line, which is dropped (the op it was recording was
  never acknowledged).  Corruption anywhere *before* the final line is a
  hard error — that is not a crash artifact;
* :meth:`WriteAheadLog.rotate` atomically replaces the log's contents
  (tmp file + ``os.replace``) — the checkpoint path truncates the log to
  the records not yet covered by the latest snapshot, keeping WAL size
  bounded over multi-day runs (pinned by the soak test).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Union

__all__ = ["WriteAheadLog", "read_wal"]


def _encode(record: Dict[str, Any]) -> str:
    return json.dumps(record, separators=(",", ":"), sort_keys=True)


def read_wal(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Read every record, dropping at most one torn final line.

    A missing file reads as empty (a fresh service has appended nothing).
    A decode failure on any line but the last raises :class:`ValueError`
    naming the line — mid-file corruption is never silently skipped.
    """
    path = Path(path)
    if not path.exists():
        return []
    raw = path.read_text(encoding="utf-8")
    lines = raw.split("\n")
    records: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            # only the final non-empty line may be torn (crash mid-append);
            # anything earlier is real corruption
            rest = "".join(lines[i + 1:]).strip()
            if rest:
                raise ValueError(
                    f"WAL {path} corrupted at line {i + 1} (not the tail): {e}"
                ) from e
            break
    return records


class WriteAheadLog:
    """Append handle over one WAL file; see module docstring."""

    def __init__(self, path: Union[str, Path], *, fsync: bool = False) -> None:
        self.path = Path(path)
        self.fsync = fsync
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, record: Dict[str, Any]) -> None:
        """Durably append one record (flush always, fsync per config)."""
        self._fh.write(_encode(record) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def rotate(self, records: Iterable[Dict[str, Any]]) -> None:
        """Atomically replace the log's contents with ``records``.

        The checkpoint path calls this with the (usually empty) tail of
        records newer than the snapshot just written; a crash during
        rotation leaves either the old or the new file, never a mix.
        """
        self._fh.close()
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in records:
                fh.write(_encode(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def size_bytes(self) -> int:
        """Current on-disk size (the soak test's WAL-bound probe)."""
        self._fh.flush()
        return self.path.stat().st_size

    def close(self) -> None:
        self._fh.close()
