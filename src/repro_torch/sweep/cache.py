"""On-disk memo cache for completed sweep cells.

One JSON file per cell under the cache directory, named
``<content-hash>.<SIM_VERSION>.json``.  Writes are atomic (tmp + rename) so
a crashed worker can never leave a torn entry, and the parent persists each
result the moment it arrives — a re-run after an interrupt recomputes only
the missing cells.

Version safety: the simulator version is part of the *filename* (and
recorded inside the payload, as a guard against hand-copied files), so
detecting entries from a different ``SIM_VERSION`` is a single ``listdir``
— no marker files, no fast paths that can be defeated.  Resuming a sweep
over a cache holding foreign-version entries raises :class:`StaleCacheError`
instead of silently proceeding: the hash already separates versions, but a
half-migrated cache directory is almost always a
bumped-``SIM_VERSION``-without-regenerated-baselines mistake the operator
should see loudly (``python -m repro_torch.sweep --purge-stale-cache`` clears
it).

The port's own copy of ``repro.sweep.cache``: the same file names and
payloads.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.simulator import SIM_VERSION

__all__ = ["SweepCache", "StaleCacheError", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join("artifacts", "sweeps", "cache")


class StaleCacheError(RuntimeError):
    """The cache holds entries computed under a different ``SIM_VERSION``."""


def _split_entry_name(name: str) -> Optional[Tuple[str, str]]:
    """``(key, version)`` from an entry filename, or None for non-entries.

    Pre-versioned-layout files (``<hash>.json``) report version ``""`` so
    they read as foreign and get refused/purged rather than ignored.
    """
    if not name.endswith(".json"):
        return None
    stem = name[: -len(".json")]
    key, _, version = stem.partition(".")
    return key, version


class SweepCache:
    """Content-addressed on-disk memo of finished cells (see module doc)."""

    def __init__(self, root: str = DEFAULT_CACHE_DIR) -> None:
        self.root = root
        self.hits = 0
        self.misses = 0
        self._checked = False

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.{SIM_VERSION}.json")

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Return the memoized result dict for ``key``, or None."""
        try:
            with open(self._path(key)) as f:
                payload = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            self.misses += 1
            return None
        if payload.get("sim_version") != SIM_VERSION:
            # the filename already pins the version; this guards files
            # hand-copied across differently-versioned cache directories
            self.misses += 1
            return None
        self.hits += 1
        return payload["result"]

    def put(self, key: str, cell: Dict[str, Any], result: Dict[str, Any]) -> None:
        """Atomically persist one finished cell under the current version."""
        os.makedirs(self.root, exist_ok=True)
        payload = {"sim_version": SIM_VERSION, "cell": cell, "result": result}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self._path(key))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------------
    # SIM_VERSION hygiene

    def scan_versions(self) -> Dict[str, int]:
        """``{sim_version: entry count}`` read off the entry filenames."""
        versions: Dict[str, int] = {}
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return versions
        for n in names:
            parsed = _split_entry_name(n)
            if parsed is None:
                continue
            versions[parsed[1]] = versions.get(parsed[1], 0) + 1
        return versions

    def check_version(self) -> None:
        """Refuse to resume over entries from a different ``SIM_VERSION``.

        A pure filename scan (one listdir, no file reads), so it runs on
        every resume; once a process has seen a clean directory it skips the
        re-scan (entries it writes afterwards are all current-version).
        """
        if self._checked:
            return
        stale = {v: c for v, c in self.scan_versions().items() if v != SIM_VERSION}
        if stale:
            detail = ", ".join(f"{c} cells at {v!r}" for v, c in sorted(stale.items()))
            raise StaleCacheError(
                f"sweep cache {self.root!r} holds entries from a different "
                f"simulator version ({detail}; current SIM_VERSION is "
                f"{SIM_VERSION!r}).  Resuming would silently mix simulation "
                f"semantics.  Run `python -m repro_torch.sweep --purge-stale-cache` "
                f"to drop the stale entries, or `--no-resume` to recompute "
                f"without reading the cache."
            )
        self._checked = True

    def purge_stale(self) -> int:
        """Delete entries whose filename version differs; returns the count."""
        removed = 0
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return removed
        for n in names:
            parsed = _split_entry_name(n)
            if parsed is not None and parsed[1] != SIM_VERSION:
                os.unlink(os.path.join(self.root, n))
                removed += 1
        return removed

    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.root) if n.endswith(".json"))
        except FileNotFoundError:
            return 0
