"""Crash-safe on-disk result store for the simulation service.

:class:`ResultStore` is the durability layer under
:class:`~.cache.ResultMemo`: an append-only JSONL file of completed
``(point key, row)`` pairs, keyed by the same canonical
:mod:`repro_torch.core.noc.fingerprint` point keys the in-memory memo uses.
A server restarted against the same store — including after ``kill -9``
— hydrates its memo from disk and serves every previously completed
point as a memo hit, bit-identical to the fresh computation (rows are
the exact JSON documents the engines produced; JSON float serialization
round-trips by ``repr``, the same property the wire protocol relies on).

File layout — one JSON document per line:

* line 1: a header ``{"kind": "repro-noc-result-store", "version": 1,
  "parts": {component: digest, ...}}``.  The per-component digests name
  the code-version identity of the rows (store format, the
  ``NoCParams`` field set, the ``SweepPoint`` row shape, the point-key
  scheme).  Opening a store whose parts differ from the running code
  refuses with a message naming the differing component(s) — the
  sweep-journal behavior — instead of silently serving rows keyed by an
  incompatible scheme.
* every further line: ``{"key": <point key>, "row": <row doc>}``.

Torn writes are tolerated: a final line cut short by a crash fails to
parse and is dropped (and counted).  Duplicate keys resolve
last-write-wins.  When a load drops torn lines or collapses duplicates
the file is **compacted** — rewritten atomically (temp file + rename)
with the surviving rows — so damage never accumulates.

Appends are buffered through a line write + ``flush()`` (the row
reaches the OS immediately, surviving a SIGKILL of the server) and
``fsync``'d every ``fsync_batch`` appends (surviving power loss at
batch granularity).  :meth:`flush` forces both; the scheduler calls it
on drain and close.  Single writer: one server owns a store file at a
time.
"""

from __future__ import annotations

import json
import os
import tempfile

from repro_torch.core.noc.fingerprint import store_schema_doc, store_schema_parts

STORE_KIND = "repro-noc-result-store"
STORE_VERSION = 1


class StoreMismatch(ValueError):
    """The store on disk was written by a different code version; the
    message names the differing component(s)."""


def _mismatch_message(path: str, stored_parts) -> str:
    current = store_schema_parts()
    if not isinstance(stored_parts, dict):
        return (f"result store {path} predates per-component digests, so "
                f"the differing component cannot be named; delete it or "
                f"pass a different store path")
    names = {"format": "store format", "params_fields": "NoCParams fields",
             "row_fields": "SweepPoint row fields",
             "point_key": "point-key scheme"}
    differing = [names.get(k, k) for k in sorted(current)
                 if stored_parts.get(k) != current[k]]
    return (f"result store {path} was written by a different code "
            f"version — differing component(s): "
            f"{', '.join(differing) or 'unknown'}; delete it or pass a "
            f"different store path")


class ResultStore:
    """Append-only, torn-write-tolerant result store (module docstring).

    ``fsync_batch`` bounds how many appended rows may sit in the OS page
    cache before an ``fsync`` — crash-of-the-process loses nothing once
    :meth:`append` returns; crash-of-the-host loses at most a batch.
    """

    def __init__(self, path: str, fsync_batch: int = 8):
        if fsync_batch < 1:
            raise ValueError(f"fsync_batch must be >= 1, got {fsync_batch}")
        self.path = path
        self.fsync_batch = fsync_batch
        self.rows_loaded = 0
        self.torn_dropped = 0
        self.duplicates_compacted = 0
        self.appends = 0
        self.flushes = 0
        self._unsynced = 0
        self._rows = self._load_and_compact()
        self._f = open(self.path, "a")

    # -- load / compact ----------------------------------------------------

    def _load_and_compact(self) -> dict:
        rows: dict[str, object] = {}
        exists = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        if not exists:
            with open(self.path, "w") as f:
                f.write(json.dumps({"kind": STORE_KIND,
                                    "version": STORE_VERSION,
                                    "schema": store_schema_doc(),
                                    "parts": store_schema_parts()}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            return rows
        with open(self.path) as f:
            lines = f.read().split("\n")
        try:
            header = json.loads(lines[0])
        except (json.JSONDecodeError, IndexError):
            raise StoreMismatch(_mismatch_message(self.path, None))
        if (header.get("kind") != STORE_KIND
                or header.get("version") != STORE_VERSION
                or header.get("parts") != store_schema_parts()):
            raise StoreMismatch(
                _mismatch_message(self.path, header.get("parts")))
        seen = 0
        for line in lines[1:]:
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
                key, row = doc["key"], doc["row"]
            except (json.JSONDecodeError, KeyError, TypeError):
                # A torn final line (crash mid-write) — drop it.  A torn
                # *interior* line cannot happen under append-only writes,
                # but dropping is still the safe recovery.
                self.torn_dropped += 1
                continue
            if key in rows:
                self.duplicates_compacted += 1
            rows[key] = row
            seen += 1
        self.rows_loaded = len(rows)
        if self.torn_dropped or self.duplicates_compacted:
            self._rewrite(rows)
        return rows

    def _rewrite(self, rows: dict) -> None:
        """Atomic compaction: header + surviving rows into a temp file,
        fsync, rename over the original."""
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(self.path) + ".compact-",
            dir=os.path.dirname(os.path.abspath(self.path)))
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"kind": STORE_KIND,
                                    "version": STORE_VERSION,
                                    "schema": store_schema_doc(),
                                    "parts": store_schema_parts()}) + "\n")
                for key, row in rows.items():
                    f.write(json.dumps({"key": key, "row": row}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- access ------------------------------------------------------------

    def rows(self) -> dict:
        """The compacted ``{key: row}`` mapping loaded at open (appends
        made through this instance included)."""
        return dict(self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, key: str) -> bool:
        return key in self._rows

    def append(self, key: str, row) -> None:
        """Durably record one completed point.  The line reaches the OS
        before this returns (process-crash safe); every ``fsync_batch``
        appends it also reaches the disk (host-crash safe)."""
        self._rows[key] = row
        self._f.write(json.dumps({"key": key, "row": row}) + "\n")
        self._f.flush()
        self.appends += 1
        self._unsynced += 1
        if self._unsynced >= self.fsync_batch:
            self._fsync()

    def _fsync(self) -> None:
        os.fsync(self._f.fileno())
        self.flushes += 1
        self._unsynced = 0

    def flush(self) -> None:
        """Force buffered appends to disk (drain / shutdown path)."""
        self._f.flush()
        if self._unsynced:
            self._fsync()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        return {
            "path": self.path,
            "rows": len(self._rows),
            "rows_loaded": self.rows_loaded,
            "torn_dropped": self.torn_dropped,
            "duplicates_compacted": self.duplicates_compacted,
            "appends": self.appends,
            "flushes": self.flushes,
        }
