"""Compile cache and result memoization for the simulation service.

Two caches exploit the redundancy of design-space exploration (sweep
grids submitted by many clients overwhelmingly revisit the same
(mesh, params, program, engine) points):

* :class:`CompileCache` — an LRU over compiled workload artifacts keyed
  on the canonical workload fingerprints of
  :mod:`repro_torch.core.noc.fingerprint`.  One entry is everything
  rate-independent about a workload (a
  :class:`~repro_torch.core.noc.program.CompiledWorkload` plus its
  :class:`~repro_torch.core.noc.traffic.patterns.SyntheticPopulation`):
  recompiling is the expensive part of a sweep point, so a warm cache
  turns a repeat grid into pure engine time.  Each service worker
  process owns one (compiled artifacts hold live stream specs and do
  not cross process boundaries); the scheduler folds their stats.
* :class:`ResultMemo` — completed ``(workload, rate)`` result rows,
  keyed on ``workload_fingerprint + token``.  A memoized point is
  returned without any simulation; results are bit-identical by
  construction because the memo stores the exact row the engine
  produced.  With a durable :class:`~.store.ResultStore` attached to
  the scheduler, the memo hydrates from disk at start and every
  completed row is written through — a restarted (even ``kill -9``'d)
  server serves yesterday's points as memo hits.

Both keep hit/miss/eviction counters; the scheduler's accounting is
exact (asserted in tests): every requested point is classified as
exactly one of memo-hit, in-flight-join, or computed.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict


@dataclasses.dataclass
class CacheStats:
    """Hit/miss/eviction counters of one cache instance."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.hits, self.misses, self.evictions)

    def to_doc(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CompileCache:
    """LRU cache of compiled workload artifacts, keyed on canonical
    workload fingerprints (:mod:`repro_torch.core.noc.fingerprint`)."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: OrderedDict[str, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str, build):
        """Return the cached artifact for ``key``, building (and
        inserting, evicting LRU entries over capacity) on a miss."""
        entry = self._entries.get(key)
        if entry is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.stats.misses += 1
        entry = build()
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return entry


class ResultMemo:
    """LRU memo of completed result rows keyed on
    ``(workload fingerprint, token)`` point keys.

    Values are the exact JSON-ready row documents the engines produced,
    so serving from the memo is bit-identical to recomputing (the
    engines are deterministic; the row *is* the result).

    :meth:`hydrate` pre-loads rows recovered from a durable
    :class:`~.store.ResultStore`; hits on hydrated keys are counted
    separately (``store_hits``) so restart-survival gates can assert
    that previously completed points really were served from disk."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.stats = CacheStats()
        self.store_hits = 0
        self._from_store: set[str] = set()
        self._rows: OrderedDict[str, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, key: str) -> bool:
        """Membership peek that counts nothing (admission control must
        not skew the hit/miss accounting)."""
        return key in self._rows

    def hydrate(self, rows: dict) -> None:
        """Pre-load recovered ``{key: row}`` pairs (store hydration at
        server start).  Counts nothing; hits on these keys increment
        ``store_hits`` in addition to the ordinary hit counter."""
        for key, row in rows.items():
            self._rows[key] = row
            self._rows.move_to_end(key)
            self._from_store.add(key)
            while len(self._rows) > self.capacity:
                old, _ = self._rows.popitem(last=False)
                self._from_store.discard(old)
                self.stats.evictions += 1

    def get(self, key: str):
        """The memoized row for ``key`` or ``None``; counts a hit or a
        miss accordingly."""
        row = self._rows.get(key)
        if row is not None:
            self.stats.hits += 1
            if key in self._from_store:
                self.store_hits += 1
            self._rows.move_to_end(key)
        else:
            self.stats.misses += 1
        return row

    def put(self, key: str, row) -> None:
        self._rows[key] = row
        self._rows.move_to_end(key)
        while len(self._rows) > self.capacity:
            old, _ = self._rows.popitem(last=False)
            self._from_store.discard(old)
            self.stats.evictions += 1
