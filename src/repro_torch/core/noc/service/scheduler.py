"""Slot-based job scheduler over persistent supervised worker processes.

The execution core of the simulation service: jobs (parsed by
:mod:`~repro_torch.core.noc.service.jobs`) decompose into memoizable points,
points group into per-workload *chunks*, and chunks fan out across a
fixed pool of persistent fork workers — the slot/refill discipline of
``runtime/server.py``'s continuous-batching loop applied to simulation
requests:

* **Memoization first.**  Every requested point is classified, exactly
  once, as a memo hit (row served instantly from
  :class:`~.cache.ResultMemo`), an in-flight join (another client
  already queued or started the same point — subscribe, never
  recompute), or newly computed.  The accounting is exact:
  ``memo.hits + inflight_joins + points_computed == points_total``
  always (asserted in tests), and the joined/hit fraction is the
  service cache hit rate.
* **Per-client fairness.**  Each client has its own chunk queue; free
  slots refill round-robin across clients, so a client with one small
  job is not starved behind another's thousand-point grid.
* **Supervision.**  Workers are persistent fork processes with
  :class:`~repro_torch.core.noc.resilience.supervise.Heartbeat` stamps; the
  dispatch loop detects dead (process exited) and wedged (alive but
  silent past the deadline) workers, respawns them under the
  :class:`~repro_torch.core.noc.resilience.supervise.SuperviseConfig` budget
  and requeues their in-flight chunks — a SIGKILLed worker costs one
  retry, never a duplicate or missing row.  A spent budget (or a
  platform that cannot fork) degrades the scheduler to in-process
  execution; it never stops serving.
* **Bit-identity.**  Workers and the in-process path both run chunks
  through :func:`~.jobs.execute_workload` — the same compile-once
  ``measure``/``run_program`` calls the direct APIs make — so memoized,
  fanned-out and serial results are all bit-identical to calling
  ``saturation_sweep``/``run_program`` yourself.

Telemetry is opt-in: pass a
:class:`~repro_torch.core.noc.telemetry.Collector` and the scheduler records
one op span per job (label ``job:<id>:<kind>``, comm lane, milliseconds)
plus ``service.queue_depth`` / ``service.slots_busy`` /
``service.cache_hit_rate`` counter samples, all exportable through the
existing Perfetto writer.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import signal
import threading
import time
import warnings
from collections import deque
from typing import Callable, Optional, Union

from repro_torch.core.noc.resilience.supervise import (
    Heartbeat,
    SuperviseConfig,
    reap,
)
from repro_torch.core.noc.service.cache import CacheStats, CompileCache, ResultMemo
from repro_torch.core.noc.service.jobs import execute_workload, job_from_doc
from repro_torch.core.noc.service.store import ResultStore


class SchedulerOverloaded(RuntimeError):
    """Admission refused: the queue is at its bound (or the scheduler is
    draining).  ``retry_after_s`` is the server's estimate of when the
    backlog will have drained enough to accept the job."""

    def __init__(self, message: str, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__(f"{message}; retry after {retry_after_s:.1f}s")


def _worker_main(conn, heartbeat, cache_capacity: int) -> None:
    """Persistent worker loop: receive ``("chunk", id, doc, tokens)``,
    execute through the shared :func:`execute_workload` path against a
    process-local :class:`CompileCache`, reply ``("rows", id, rows,
    stats_delta)`` — or ``("error", id, message)`` for a deterministic
    failure, which must surface to the submitting client as itself, not
    as a retry loop.  ``("stop",)`` (or a torn pipe) exits."""
    cache = CompileCache(cache_capacity)
    last = (0, 0, 0)
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg[0] == "stop":
            break
        _, chunk_id, doc, tokens = msg
        heartbeat.beat()
        try:
            rows = execute_workload(doc, tokens, cache)
        except Exception as exc:  # noqa: BLE001 - reported, not retried
            try:
                conn.send(("error", chunk_id,
                           f"{type(exc).__name__}: {exc}"))
            except (BrokenPipeError, OSError):
                break
            continue
        cur = cache.stats.as_tuple()
        delta = tuple(c - p for c, p in zip(cur, last))
        last = cur
        try:
            conn.send(("rows", chunk_id, rows, delta))
        except (BrokenPipeError, OSError):
            break


@dataclasses.dataclass
class _Chunk:
    """One dispatchable unit: a workload document plus the tokens (and
    their memo point keys) it still owes."""

    id: str
    client: str
    doc: dict
    tokens: list
    keys: list
    attempts: int = 0


class _Pending:
    """An in-flight or queued point: who is waiting for it."""

    __slots__ = ("key", "subs")

    def __init__(self, key: str):
        self.key = key
        self.subs: list = []          # (job, row_index)


class _Job:
    __slots__ = ("id", "client", "kind", "on_event", "rows_total",
                 "remaining", "state", "keys", "t0")

    def __init__(self, jid: str, client: str, kind: str, rows_total: int,
                 on_event: Callable, t0: float):
        self.id = jid
        self.client = client
        self.kind = kind
        self.on_event = on_event
        self.rows_total = rows_total
        self.remaining = rows_total
        self.state = "active"
        self.keys: set = set()        # pending point keys subscribed to
        self.t0 = t0


class _Worker:
    __slots__ = ("proc", "conn", "heartbeat", "chunk", "sent_t")

    def __init__(self, proc, conn, heartbeat):
        self.proc = proc
        self.conn = conn
        self.heartbeat = heartbeat
        self.chunk: Optional[_Chunk] = None
        self.sent_t = 0.0


class Scheduler:
    """Persistent simulation scheduler (see module docstring).

    ``workers=0`` runs everything in-process (no fork); ``workers=None``
    sizes the pool to ``min(2, cpu count)``.  ``chunk_tokens`` bounds
    how many points of one workload ride a single dispatch — smaller
    chunks stream first rows sooner and parallelize one job across
    slots; larger ones amortize the compile further.

    ``store`` (a :class:`~.store.ResultStore` or a path) makes the
    result memo durable: the memo hydrates from disk at construction
    and every completed row is written through, so a restarted — even
    ``kill -9``'d — scheduler serves previously completed points as
    memo hits, bit-identical to recomputing them.  ``max_queue_points``
    bounds admission: a submission whose *fresh* points would push the
    backlog past the bound is refused with
    :class:`SchedulerOverloaded` (carrying a retry-after estimate from
    the measured per-point wall), before any accounting or events.
    :meth:`drain` is the graceful-shutdown half: stop admitting, finish
    in-flight work, flush the store.
    """

    def __init__(self, workers: Optional[int] = None, chunk_tokens: int = 8,
                 memo_capacity: int = 65536, compile_capacity: int = 8,
                 supervise: Optional[SuperviseConfig] = None,
                 telemetry=None, store: Union[ResultStore, str, None] = None,
                 max_queue_points: Optional[int] = None):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        if max_queue_points is not None and max_queue_points < 1:
            raise ValueError(
                f"max_queue_points must be >= 1, got {max_queue_points}")
        self.cfg = supervise or SuperviseConfig()
        self.chunk_tokens = chunk_tokens
        self.compile_capacity = compile_capacity
        self.max_queue_points = max_queue_points
        self.telemetry = telemetry
        self.memo = ResultMemo(memo_capacity)
        self.store = (ResultStore(store) if isinstance(store, str)
                      else store)
        if self.store is not None:
            self.memo.hydrate(self.store.rows())
        self._local_cache = CompileCache(compile_capacity)
        self._worker_compile = CacheStats()   # folded worker-side deltas

        self._lock = threading.RLock()
        self._pending: dict[str, _Pending] = {}
        self._queues: dict[str, deque] = {}
        self._rr = 0
        self._jobs: dict[str, _Job] = {}
        self._job_seq = 0
        self._chunk_seq = 0

        # Exact point accounting (memo.hits + joins + computed == total).
        self.points_total = 0
        self.points_computed = 0
        self.inflight_joins = 0
        self.jobs_submitted = 0
        self.jobs_done = 0
        self.jobs_cancelled = 0
        self.jobs_failed = 0
        self.worker_respawns = 0
        self.chunk_retries = 0

        # Test hook: SIGKILL the worker that receives the Nth dispatched
        # chunk (1-based), once — deterministic kill-recovery coverage.
        self.chaos_kill_after: Optional[int] = None
        self._dispatched = 0
        # Chaos hook for the *server* side of the resilience story:
        # SIGKILL this whole process right after the Nth completed chunk
        # has been durably flushed to the store — the restart-survival
        # harness (``server.ServerProcess``) runs the scheduler in a
        # child process and sets this to die mid-stream, deterministically
        # after N chunks' rows are on disk.
        self.chaos_kill_server_after: Optional[int] = None
        self._chunks_completed = 0

        self._draining = False
        # EMA of the per-point compute wall, feeding the retry-after
        # hint of overload rejections (seeded pessimistically; real
        # completions converge it within one chunk).
        self._point_ema_s = 0.5

        self._t0 = time.monotonic()
        self._inline = workers == 0
        self._degraded = False
        self._workers: list[_Worker] = []
        if not self._inline:
            n = workers if workers is not None else min(2, os.cpu_count() or 1)
            try:
                self._ctx = mp.get_context("fork")
                for _ in range(n):
                    self._workers.append(self._spawn())
            except (ValueError, OSError, AttributeError) as exc:
                warnings.warn(
                    f"service scheduler: cannot fork workers ({exc!r}); "
                    f"running in-process", RuntimeWarning, stacklevel=2)
                self._workers = []
                self._inline = True

        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="service-scheduler", daemon=True)
        self._thread.start()

    # -- worker pool -------------------------------------------------------

    def _spawn(self) -> _Worker:
        parent, child = self._ctx.Pipe(duplex=True)
        hb = Heartbeat(self._ctx)
        proc = self._ctx.Process(
            target=_worker_main, args=(child, hb, self.compile_capacity),
            daemon=True)
        proc.start()
        child.close()
        return _Worker(proc, parent, hb)

    # -- submission API ----------------------------------------------------

    def _backlog_points(self) -> int:
        """Points queued or riding a busy slot (lock held)."""
        queued = sum(len(c.keys) for q in self._queues.values() for c in q)
        inflight = sum(len(w.chunk.keys) for w in self._workers
                       if w.chunk is not None)
        return queued + inflight

    def _retry_after(self, backlog: int) -> float:
        return min(60.0, max(0.1, backlog * self._point_ema_s))

    def submit(self, client: str, doc: dict, on_event: Callable) -> str:
        """Register one job; fires ``accepted`` (with the row layout),
        then ``rows`` events as points land, then exactly one of
        ``done`` / ``cancelled`` / ``error``.  Raises ``ValueError`` on
        a malformed document — nothing is enqueued — and
        :class:`SchedulerOverloaded` (with a retry-after hint) when the
        admission queue is at its bound or the scheduler is draining."""
        job_spec = job_from_doc(doc)
        workloads = job_spec.workloads()
        groups = []
        points = []                   # (row_index, workload, token)
        for wl in workloads:
            groups.append({"meta": wl.meta, "start": len(points),
                           "count": len(wl.tokens)})
            for tok in wl.tokens:
                points.append((len(points), wl, tok))

        with self._lock:
            if self._draining:
                raise SchedulerOverloaded(
                    "service is draining and accepts no new jobs",
                    self._retry_after(self._backlog_points()))
            if self.max_queue_points is not None:
                # Count only the points this job would actually add to
                # the backlog — memoized and already-pending points cost
                # nothing (a membership peek; no stats are skewed).
                backlog = self._backlog_points()
                fresh = sum(1 for _idx, wl, tok in points
                            if wl.point_key(tok) not in self.memo
                            and wl.point_key(tok) not in self._pending)
                if backlog + fresh > self.max_queue_points:
                    raise SchedulerOverloaded(
                        f"admission queue full ({backlog} point(s) "
                        f"backlogged + {fresh} new > bound "
                        f"{self.max_queue_points})",
                        self._retry_after(backlog))
            self._job_seq += 1
            job = _Job(f"j{self._job_seq}", client, job_spec.kind,
                       len(points), on_event, self._now())
            self._jobs[job.id] = job
            self.jobs_submitted += 1
            self.points_total += len(points)
            self._fire(job, {"event": "accepted", "job": job.id,
                             "kind": job.kind, "rows_total": len(points),
                             "fingerprint": job_spec.fingerprint(),
                             "groups": groups})

            memoized = []
            fresh: dict[int, list] = {}   # workload -> [(wl, idx, tok, key)]
            for idx, wl, tok in points:
                key = wl.point_key(tok)
                row = self.memo.get(key)
                if row is not None:
                    memoized.append([idx, row])
                    continue
                p = self._pending.get(key)
                if p is not None:
                    p.subs.append((job, idx))
                    job.keys.add(key)
                    self.inflight_joins += 1
                    continue
                p = _Pending(key)
                p.subs.append((job, idx))
                self._pending[key] = p
                job.keys.add(key)
                self.points_computed += 1
                fresh.setdefault(id(wl), []).append((wl, idx, tok, key))

            for group in fresh.values():
                wl = group[0][0]
                for i in range(0, len(group), self.chunk_tokens):
                    part = group[i:i + self.chunk_tokens]
                    self._chunk_seq += 1
                    self._enqueue(_Chunk(
                        id=f"c{self._chunk_seq}", client=client, doc=wl.doc,
                        tokens=[tok for _, _, tok, _ in part],
                        keys=[key for _, _, _, key in part]))

            if memoized:
                job.remaining -= len(memoized)
                self._fire(job, {"event": "rows", "job": job.id,
                                 "rows": memoized})
            if job.remaining == 0:
                self._finish(job, "done")
            self._sample()
        self._kick.set()
        return job.id

    def cancel(self, job_id: str) -> bool:
        """Cancel an active job: unsubscribe its pending points (queued
        points nobody else wants are dropped before ever occupying a
        slot; in-flight ones complete into the memo) and fire
        ``cancelled``.  Returns whether anything was cancelled."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != "active":
                return False
            self._unsubscribe(job)
            self._finish(job, "cancelled")
            self._sample()
        self._kick.set()
        return True

    def stats(self) -> dict:
        """Point-exact service counters (see module docstring)."""
        with self._lock:
            compile_stats = CacheStats(
                *(a + b for a, b in zip(
                    self._worker_compile.as_tuple(),
                    self._local_cache.stats.as_tuple())))
            served = self.memo.stats.hits + self.inflight_joins
            return {
                "jobs": {"submitted": self.jobs_submitted,
                         "done": self.jobs_done,
                         "cancelled": self.jobs_cancelled,
                         "failed": self.jobs_failed},
                "points": {"total": self.points_total,
                           "computed": self.points_computed,
                           "inflight_joins": self.inflight_joins,
                           "memo_hits": self.memo.stats.hits,
                           "store_hits": self.memo.store_hits,
                           "hit_rate": (served / self.points_total
                                        if self.points_total else 0.0)},
                "memo": self.memo.stats.to_doc(),
                "compile_cache": compile_stats.to_doc(),
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "slots_busy": sum(1 for w in self._workers
                                  if w.chunk is not None),
                "workers": len(self._workers),
                "degraded": self._degraded or self._inline,
                "worker_respawns": self.worker_respawns,
                "chunk_retries": self.chunk_retries,
                "max_queue_points": self.max_queue_points,
                "draining": self._draining,
                "store": (self.store.stats() if self.store is not None
                          else None),
            }

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful drain: stop admitting jobs, let every already
        accepted job reach its terminal event (in-flight chunks finish;
        their rows land in the store), flush the store, and return the
        final :meth:`stats`.  Safe to call more than once; ``timeout``
        bounds the wait (the drain still stops admission and flushes
        whatever completed)."""
        with self._lock:
            self._draining = True
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self._lock:
                active = any(j.state == "active"
                             for j in self._jobs.values())
            if not active:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            self._kick.set()
            time.sleep(self.cfg.poll_interval_s)
        if self.store is not None:
            self.store.flush()
        return self.stats()

    def close(self) -> None:
        """Stop the loop and tear the pool down (terminate/kill
        escalation via :func:`~repro_torch.core.noc.resilience.supervise.reap`)."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=30)
        for w in self._workers:
            try:
                w.conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        reap([w.proc for w in self._workers],
             join_timeout_s=self.cfg.join_timeout_s,
             term_timeout_s=self.cfg.term_timeout_s)
        for w in self._workers:
            w.conn.close()
        self._workers = []
        if self.store is not None:
            self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ---------------------------------------------------------

    def _now(self) -> float:
        return (time.monotonic() - self._t0) * 1e3   # ms on the job lane

    def _fire(self, job: _Job, event: dict) -> None:
        try:
            job.on_event(event)
        except Exception:  # noqa: BLE001 - a dead client must not stall
            pass           # the loop; disconnects cancel via the server

    def _finish(self, job: _Job, state: str, message: str = "") -> None:
        job.state = state
        event = {"event": state, "job": job.id}
        if state == "done":
            self.jobs_done += 1
        elif state == "cancelled":
            self.jobs_cancelled += 1
        else:
            self.jobs_failed += 1
            event["message"] = message
        if self.telemetry is not None:
            self.telemetry.ops.append(
                (f"job:{job.id}:{job.kind}", "comm", job.t0, self._now()))
        self._fire(job, event)

    def _unsubscribe(self, job: _Job) -> None:
        for key in job.keys:
            p = self._pending.get(key)
            if p is not None:
                p.subs = [s for s in p.subs if s[0] is not job]
        job.keys.clear()

    def _enqueue(self, chunk: _Chunk) -> None:
        self._queues.setdefault(chunk.client, deque()).append(chunk)

    def _requeue(self, chunk: _Chunk) -> None:
        self._queues.setdefault(chunk.client, deque()).appendleft(chunk)

    def _next_chunk(self) -> Optional[_Chunk]:
        """Round-robin pop across client queues, dropping points (and
        whole chunks) that lost every subscriber to cancellation."""
        clients = list(self._queues)
        if not clients:
            return None
        n = len(clients)
        for i in range(n):
            client = clients[(self._rr + i) % n]
            q = self._queues[client]
            while q:
                chunk = q.popleft()
                live_tokens, live_keys = [], []
                for tok, key in zip(chunk.tokens, chunk.keys):
                    p = self._pending.get(key)
                    if p is not None and p.subs:
                        live_tokens.append(tok)
                        live_keys.append(key)
                    else:
                        # Nobody wants this point any more: forget it
                        # before it costs a slot.
                        if p is not None:
                            del self._pending[key]
                            self.points_computed -= 1
                            self.points_total -= 1
                if not live_tokens:
                    continue
                chunk.tokens, chunk.keys = live_tokens, live_keys
                if not q:
                    del self._queues[client]
                self._rr = (self._rr + i + 1) % max(1, len(self._queues))
                return chunk
            del self._queues[client]
        return None

    def _sample(self) -> None:
        if self.telemetry is None:
            return
        t = self._now()
        self.telemetry.sample_counter(
            "service.queue_depth", t,
            sum(len(q) for q in self._queues.values()))
        self.telemetry.sample_counter(
            "service.slots_busy", t,
            sum(1 for w in self._workers if w.chunk is not None))
        served = self.memo.stats.hits + self.inflight_joins
        self.telemetry.sample_counter(
            "service.cache_hit_rate", t,
            served / self.points_total if self.points_total else 0.0)
        if self.store is not None:
            # Store observability rides the same counter tracks; absent
            # entirely on a store-less server so its sample stream (and
            # the Perfetto output) is untouched.
            self.telemetry.sample_counter(
                "service.store_hits", t, self.memo.store_hits)
            self.telemetry.sample_counter(
                "service.store_flushes", t, self.store.flushes)

    # -- dispatch loop -----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            progressed = self._refill()
            progressed |= self._drain()
            if self._inline or self._degraded:
                progressed |= self._run_inline()
            if not progressed:
                self._kick.wait(timeout=self.cfg.poll_interval_s)
                self._kick.clear()

    def _refill(self) -> bool:
        """Fill every free slot with the next fair-share chunk."""
        if self._inline or self._degraded:
            return False
        sent = False
        with self._lock:
            for w in self._workers:
                if w.chunk is not None:
                    continue
                chunk = self._next_chunk()
                if chunk is None:
                    break
                w.chunk = chunk
                w.sent_t = time.monotonic()
                try:
                    w.conn.send(("chunk", chunk.id, chunk.doc, chunk.tokens))
                except (BrokenPipeError, OSError):
                    self._on_worker_failure(w, "send failed")
                    continue
                sent = True
                self._dispatched += 1
                if (self.chaos_kill_after is not None
                        and self._dispatched >= self.chaos_kill_after):
                    self.chaos_kill_after = None
                    w.proc.kill()      # SIGKILL mid-chunk, by request
            if sent:
                self._sample()
        return sent

    def _drain(self) -> bool:
        """Collect replies; detect dead and wedged workers."""
        if self._inline or self._degraded:
            return False
        progressed = False
        for w in list(self._workers):
            if w.chunk is None:
                # An idle worker that died (e.g. chaos-killed right after
                # its reply) must be replaced now — a chunk sent to a
                # corpse would stall until the wedge deadline.
                if not w.proc.is_alive():
                    with self._lock:
                        self._on_worker_failure(
                            w, f"exited idle with code {w.proc.exitcode}")
                    progressed = True
                continue
            try:
                has_msg = w.conn.poll(0)
            except (EOFError, OSError):
                has_msg = False
            if has_msg:
                try:
                    msg = w.conn.recv()
                except (EOFError, OSError):
                    with self._lock:
                        self._on_worker_failure(w, "pipe broke")
                    progressed = True
                    continue
                with self._lock:
                    self._on_reply(w, msg)
                progressed = True
                continue
            if not w.proc.is_alive():
                # Drain a final reply a worker managed to flush before
                # dying (the supervised_recv contract).
                try:
                    if w.conn.poll(0):
                        msg = w.conn.recv()
                        with self._lock:
                            self._on_reply(w, msg)
                        progressed = True
                        continue
                except (EOFError, OSError):
                    pass
                with self._lock:
                    self._on_worker_failure(
                        w, f"exited with code {w.proc.exitcode}")
                progressed = True
                continue
            ref = max(w.sent_t, w.heartbeat.last())
            if time.monotonic() - ref > self.cfg.op_deadline_s:
                w.proc.kill()
                with self._lock:
                    self._on_worker_failure(w, "wedged past deadline")
                progressed = True
        return progressed

    def _run_inline(self) -> bool:
        """Degraded / in-process execution: one chunk per pass, computed
        on this thread through the exact same ``execute_workload`` path."""
        with self._lock:
            chunk = self._next_chunk()
        if chunk is None:
            return False
        t0 = time.monotonic()
        try:
            rows = execute_workload(chunk.doc, chunk.tokens,
                                    self._local_cache)
        except Exception as exc:  # noqa: BLE001 - deterministic failure
            with self._lock:
                self._complete_error(chunk, f"{type(exc).__name__}: {exc}")
            return True
        with self._lock:
            if rows:
                self._note_point_wall((time.monotonic() - t0) / len(rows))
            self._complete_rows(chunk, rows)
        return True

    def _note_point_wall(self, per_point_s: float) -> None:
        self._point_ema_s += 0.3 * (per_point_s - self._point_ema_s)

    # -- completion / failure handling (lock held) -------------------------

    def _on_reply(self, w: _Worker, msg) -> None:
        chunk, w.chunk = w.chunk, None
        kind = msg[0]
        if kind == "rows":
            _, chunk_id, rows, delta = msg
            self._worker_compile.hits += delta[0]
            self._worker_compile.misses += delta[1]
            self._worker_compile.evictions += delta[2]
            if chunk is not None and chunk.id == chunk_id:
                if rows:
                    self._note_point_wall(
                        (time.monotonic() - w.sent_t) / len(rows))
                self._complete_rows(chunk, rows)
        elif kind == "error":
            _, chunk_id, message = msg
            if chunk is not None and chunk.id == chunk_id:
                self._complete_error(chunk, message)
        self._sample()

    def _complete_rows(self, chunk: _Chunk, rows: list) -> None:
        deliveries: dict[str, list] = {}
        finished = []
        for key, row in zip(chunk.keys, rows):
            self.memo.put(key, row)
            if self.store is not None:
                self.store.append(key, row)
            p = self._pending.pop(key, None)
            if p is None:
                continue
            for job, idx in p.subs:
                if job.state != "active":
                    continue
                job.keys.discard(key)
                deliveries.setdefault(job.id, []).append([idx, row])
                job.remaining -= 1
                if job.remaining == 0:
                    finished.append(job)
        for jid, pairs in deliveries.items():
            job = self._jobs[jid]
            self._fire(job, {"event": "rows", "job": jid, "rows": pairs})
        for job in finished:
            self._finish(job, "done")
        self._chunks_completed += 1
        if (self.chaos_kill_server_after is not None
                and self._chunks_completed >= self.chaos_kill_server_after):
            # Die *after* the completed rows are durable: the restart
            # gate asserts they come back as store hits, never as
            # duplicate compute.
            if self.store is not None:
                self.store.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    def _complete_error(self, chunk: _Chunk, message: str) -> None:
        failed: list[_Job] = []
        for key in chunk.keys:
            p = self._pending.pop(key, None)
            if p is None:
                continue
            for job, _idx in p.subs:
                if job.state == "active" and job not in failed:
                    failed.append(job)
        for job in failed:
            self._unsubscribe(job)
            self._finish(job, "error", message)

    def _on_worker_failure(self, w: _Worker, reason: str) -> None:
        """Respawn under budget (requeueing the in-flight chunk — one
        retry, no duplicate or missing rows); over budget, degrade to
        in-process execution and keep serving."""
        chunk, w.chunk = w.chunk, None
        if chunk is not None:
            chunk.attempts += 1
            self.chunk_retries += 1
            self._requeue(chunk)
        if self.telemetry is not None:
            self.telemetry.annotate(
                int(self._now()), "service-worker-failure",
                f"pid {w.proc.pid}: {reason}")
        if w.proc.is_alive():
            w.proc.kill()
        if self.worker_respawns < self.cfg.max_respawns:
            self.worker_respawns += 1
            try:
                self._workers[self._workers.index(w)] = self._spawn()
                return
            except (ValueError, OSError) as exc:
                reason = f"respawn failed: {exc!r}"
        # Budget spent (or respawn impossible): drop to in-process.
        self._degraded = True
        warnings.warn(
            f"service scheduler: worker failure ({reason}) after "
            f"{self.worker_respawns} respawn(s); degrading to in-process "
            f"execution", RuntimeWarning, stacklevel=2)
        dead, self._workers = self._workers, []
        for other in dead:
            if other.chunk is not None:
                other.chunk.attempts += 1
                self.chunk_retries += 1
                self._requeue(other.chunk)
                other.chunk = None
        reap([d.proc for d in dead], join_timeout_s=0.5,
             term_timeout_s=self.cfg.term_timeout_s)
