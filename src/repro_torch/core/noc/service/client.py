"""Blocking, reconnecting client for the simulation service protocol.

:class:`ServiceClient` connects to a :class:`~.server.SimulationServer`
— over its ``AF_UNIX`` socket (``path`` is a string) or its TCP
listener (``path`` is a ``(host, port)`` tuple plus the shared
``token``) — and exposes the three job kinds as typed submit calls,
each returning a :class:`JobHandle` that streams rows as the service
completes them:

>>> with ServiceClient(server.path) as cli:
...     h = cli.submit_sweep(mesh=(8, 8), pattern="transpose",
...                          rates=[0.02, 0.05, 0.1])
...     for index, row in h.iter_rows():   # completion order
...         ...
...     points = h.sweep_points()          # rate order, SweepPoint objects

Rows are exactly the direct API's results — ``sweep_points()`` rebuilds
the :class:`~repro_torch.core.noc.traffic.sweep.SweepPoint` dataclasses
field-identically (JSON floats round-trip exactly), and
``policy_sweeps()`` regroups a policy-compare job into the same
:class:`~repro_torch.core.noc.traffic.sweep.PolicySweep` rows
``compare_policies`` returns.

One reader thread demultiplexes events into per-job buffers under a
condition variable; any number of jobs can be in flight concurrently on
one connection.  A job that ends in ``error`` raises
:class:`ServiceError` from whichever accessor is waiting on it — an
overload rejection as :class:`ServiceOverloaded` (carrying the server's
``retry_after_s`` hint), a wait that expires as :class:`ServiceTimeout`
(also a ``TimeoutError``, so existing handlers keep working).

Resilience (``resume=True``): connection loss — including the server
being ``kill -9``'d mid-stream — triggers reconnection with capped
exponential backoff plus jitter, and every non-terminal job is
**idempotently resubmitted** under a fresh request id bound to the same
:class:`JobHandle`.  The re-accepted job's fingerprint must match the
original (same canonical job identity ⇒ same rows); rows are keyed by
row index so re-delivered ones are skipped, and ``iter_rows`` never
yields a row twice.  Against a server restarted on the same durable
store, the resubmission costs zero duplicate compute: completed points
come back as store hits.  Events within one connection carry a
monotonic per-job ``seq`` (tracked as ``JobHandle.last_seq``).
"""

from __future__ import annotations

import json
import random
import socket
import threading
from typing import Iterator, Optional, Union

from repro_torch.core.noc.service.jobs import (
    PolicyCompareJob,
    RunProgramJob,
    SweepJob,
)

Address = Union[str, tuple]


class ServiceError(RuntimeError):
    """The service rejected or failed a job (deterministic execution
    errors surface here, named — never as a hang or a retry loop)."""


class ServiceTimeout(ServiceError, TimeoutError):
    """A wait on the service expired.  Subclasses ``TimeoutError`` so
    callers written against the old bare-``TimeoutError`` behavior keep
    working, and ``ServiceError`` so one handler catches everything the
    client raises."""


class ServiceOverloaded(ServiceError):
    """The service refused admission (queue at bound, or draining).
    ``retry_after_s`` is the server's backlog-drain estimate."""

    def __init__(self, message: str, retry_after_s: float):
        self.retry_after_s = retry_after_s
        super().__init__(message)


class _JobState:
    __slots__ = ("req", "doc", "accepted", "rows", "terminal", "message",
                 "retry_after_s", "last_seq")

    def __init__(self, req: str, doc: dict):
        self.req = req
        self.doc = doc                        # kept for idempotent resubmit
        self.accepted: Optional[dict] = None
        self.rows: dict[int, object] = {}
        self.terminal: Optional[str] = None   # done/cancelled/error
        self.message = ""
        self.retry_after_s: Optional[float] = None
        self.last_seq = -1

    def raise_error(self) -> None:
        if self.retry_after_s is not None:
            raise ServiceOverloaded(self.message, self.retry_after_s)
        raise ServiceError(self.message)


class JobHandle:
    """One submitted job: streamed rows plus typed result accessors."""

    def __init__(self, client: "ServiceClient", state: _JobState):
        self._client = client
        self._state = state

    @property
    def rows_total(self) -> int:
        self._client._wait(lambda: self._state.accepted is not None
                           or self._state.terminal is not None)
        if self._state.accepted is None:
            self._state.message = self._state.message or "job rejected"
            self._state.raise_error()
        return self._state.accepted["rows_total"]

    @property
    def fingerprint(self) -> str:
        self.rows_total
        return self._state.accepted["fingerprint"]

    @property
    def last_seq(self) -> int:
        """Highest event sequence number seen on the current connection
        (monotonic per job per connection; restarts after a resume)."""
        return self._state.last_seq

    def iter_rows(self) -> Iterator[tuple[int, object]]:
        """Yield ``(index, row)`` pairs in completion order — streaming:
        rows of finished chunks arrive while others still simulate.
        Rows re-delivered after a resume are skipped (row indices are
        the idempotency key), so every index is yielded exactly once."""
        yielded: set = set()
        st = self._state
        while True:
            self._client._wait(
                lambda: len(st.rows) > len(yielded) or st.terminal is not None)
            with self._client._cond:
                # dict insertion order == completion order.
                pairs = [(k, row) for k, row in st.rows.items()
                         if k not in yielded]
                terminal, message = st.terminal, st.message
            for k, row in pairs:
                yield (k, row)
                yielded.add(k)
            if terminal is not None and not pairs:
                if terminal == "error":
                    st.raise_error()
                return

    def collect(self) -> list:
        """All rows, in row-index order (rate order / policy-major
        order).  Blocks until the job is done; raises on error or
        cancellation."""
        st = self._state
        self._client._wait(lambda: st.terminal is not None)
        if st.terminal == "error":
            st.raise_error()
        if st.terminal == "cancelled":
            raise ServiceError("job was cancelled")
        return [st.rows[i] for i in range(st.accepted["rows_total"])]

    def sweep_points(self) -> list:
        """Rows rebuilt as :class:`SweepPoint` dataclasses (rate order),
        field-identical to a direct ``saturation_sweep`` call."""
        from repro_torch.core.noc.traffic.sweep import SweepPoint

        return [SweepPoint(**row) for row in self.collect()]

    def policy_sweeps(self, knee: float = 3.0) -> list:
        """A policy-compare job's rows regrouped into
        :class:`PolicySweep` rows, identical to ``compare_policies``."""
        from repro_torch.core.noc.traffic.sweep import (
            PolicySweep,
            SweepPoint,
            saturation_rate,
        )

        rows = self.collect()
        out = []
        for g in self._state.accepted["groups"]:
            pts = tuple(SweepPoint(**row)
                        for row in rows[g["start"]:g["start"] + g["count"]])
            out.append(PolicySweep(
                policy=g["meta"]["policy"], num_vcs=g["meta"]["num_vcs"],
                points=pts, saturation=saturation_rate(pts, knee=knee)))
        return out

    def result(self) -> dict:
        """A run-program job's single result row (makespan, phase_end,
        per-op [id, inject, done] cycles)."""
        return self.collect()[0]

    def cancel(self) -> None:
        self._client._send({"op": "cancel", "req": self._state.req})

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until terminal; returns ``"done"`` / ``"cancelled"`` /
        ``"error"``.  Raises :class:`ServiceTimeout` — never hangs past
        ``timeout`` (or the client's default read timeout)."""
        self._client._wait(lambda: self._state.terminal is not None,
                           timeout=timeout)
        if self._state.terminal is None:
            raise ServiceTimeout(f"job {self._state.req} still running")
        return self._state.terminal


class ServiceClient:
    """One connection to a :class:`SimulationServer`.

    ``path`` addresses the server: a string is an ``AF_UNIX`` socket
    path; a ``(host, port)`` tuple is the TCP listener, which requires
    the shared ``token`` (the client authenticates before anything
    else; a wrong token fails fast with :class:`ServiceError`, it is
    never retried).

    ``connect_timeout`` bounds connection establishment (including the
    auth handshake); ``timeout`` is the default read timeout of every
    blocking accessor — both default on, so a dead server is an
    exception, not a hang.  ``resume=True`` enables reconnection with
    capped exponential backoff and idempotent resubmission of in-flight
    jobs (module docstring); ``max_retries`` bounds the attempts per
    outage.
    """

    def __init__(self, path: Address, timeout: float = 300.0,
                 token: Optional[str] = None, connect_timeout: float = 10.0,
                 resume: bool = False, max_retries: int = 5,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0):
        self.address = path
        self.token = token
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self.resume = resume
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = random.Random(f"service-client:{path!r}")
        if isinstance(path, tuple) and not token:
            raise ValueError("a TCP address requires the server's shared "
                             "token (token=...)")
        self._wlock = threading.Lock()
        self._cond = threading.Condition()
        self._jobs: dict[str, _JobState] = {}
        self._stats: dict[str, dict] = {}
        self._seq = 0
        self._closed = False
        self._rbuf = b""
        # resume=True retries the *initial* connect too (a resilient
        # client may legitimately start before its server).
        self._sock = (self._connect_with_backoff() if resume
                      else self._connect_once())
        self._reader = threading.Thread(
            target=self._read_loop, name="service-client", daemon=True)
        self._reader.start()

    # -- connection establishment ------------------------------------------

    def _connect_once(self):
        """One connection attempt: dial, then (TCP) authenticate —
        refused auth is terminal, never retried."""
        if isinstance(self.address, tuple):
            sock = socket.create_connection(
                self.address, timeout=self.connect_timeout)
        else:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self.connect_timeout)
            sock.connect(self.address)
        try:
            if isinstance(self.address, tuple):
                sock.sendall((json.dumps(
                    {"op": "auth", "token": self.token}) + "\n").encode())
                reply = json.loads(self._recv_line(sock))
                if reply.get("event") != "auth_ok":
                    raise ServiceError(
                        reply.get("message", "authentication refused"))
            sock.settimeout(None)
            return sock
        except BaseException:
            sock.close()
            raise

    def _connect_with_backoff(self):
        """Dial with capped exponential backoff plus jitter.  Auth
        refusal propagates immediately (retrying a bad token is a
        reconnect storm, not resilience)."""
        import time

        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if self._closed:
                raise ServiceError("client is closed")
            try:
                return self._connect_once()
            except ServiceError:
                raise
            except (OSError, json.JSONDecodeError, ValueError) as exc:
                last = exc
                if attempt == self.max_retries:
                    break
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** attempt))
                time.sleep(delay * (0.5 + 0.5 * self._rng.random()))
        raise ServiceError(
            f"could not connect to {self.address!r} after "
            f"{self.max_retries + 1} attempt(s): {last!r}")

    def _recv_line(self, sock) -> bytes:
        """Read one ``\\n``-terminated line (handshake phase); bytes
        beyond the newline are kept for the reader loop."""
        buf = self._rbuf
        while b"\n" not in buf:
            data = sock.recv(65536)
            if not data:
                raise ServiceError("connection closed during handshake")
            buf += data
        line, self._rbuf = buf.split(b"\n", 1)
        return line

    # -- submissions -------------------------------------------------------

    def submit_job(self, doc: dict) -> JobHandle:
        """Submit a raw job document (see :mod:`~.jobs`)."""
        with self._cond:
            self._seq += 1
            req = f"r{self._seq}"
            state = _JobState(req, doc)
            self._jobs[req] = state
        self._send({"op": "submit", "req": req, "job": doc})
        return JobHandle(self, state)

    def submit_sweep(self, **kw) -> JobHandle:
        """Submit a saturation sweep (``SweepJob`` fields as kwargs)."""
        return self.submit_job(SweepJob(**kw).to_doc())

    def submit_policy_compare(self, **kw) -> JobHandle:
        """Submit a (policy x VC) comparison (``PolicyCompareJob``
        fields as kwargs)."""
        return self.submit_job(PolicyCompareJob(**kw).to_doc())

    def submit_program(self, prog, **kw) -> JobHandle:
        """Submit a program execution: ``prog`` is a live
        :class:`~repro_torch.core.noc.program.Program` (``RunProgramJob``
        fields as kwargs)."""
        return self.submit_job(RunProgramJob.of(prog, **kw).to_doc())

    def stats(self) -> dict:
        """The scheduler's point-exact service counters."""
        with self._cond:
            self._seq += 1
            req = f"r{self._seq}"
        self._send({"op": "stats", "req": req})
        self._wait(lambda: req in self._stats)
        with self._cond:
            return self._stats.pop(req)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5)
        with self._cond:
            self._cond.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- wire --------------------------------------------------------------

    def _send(self, doc: dict) -> None:
        if self._closed:
            raise ServiceError("client is closed")
        try:
            with self._wlock:
                self._sock.sendall((json.dumps(doc) + "\n").encode())
        except OSError as exc:
            raise ServiceError(f"connection lost while sending: {exc}")

    def _wait(self, predicate, timeout: Optional[float] = None) -> None:
        deadline = timeout if timeout is not None else self.timeout
        with self._cond:
            if not self._cond.wait_for(
                    lambda: predicate() or self._closed, timeout=deadline):
                raise ServiceTimeout(
                    f"service reply not received within {deadline:g}s")
            if self._closed and not predicate():
                raise ServiceError("connection closed while waiting")

    # -- reader / resume ---------------------------------------------------

    def _read_loop(self) -> None:
        while True:
            buf, self._rbuf = self._rbuf, b""
            sock = self._sock
            while True:
                try:
                    data = sock.recv(65536)
                except OSError:
                    data = b""
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._dispatch(json.loads(line))
            if self._closed or not self.resume:
                break
            if not self._resume_connection():
                break
        with self._cond:
            self._closed = True
            for st in self._jobs.values():
                if st.terminal is None:
                    st.terminal = "error"
                    st.message = "connection closed"
            self._cond.notify_all()

    def _resume_connection(self) -> bool:
        """Reconnect after an unexpected disconnect and idempotently
        resubmit every non-terminal job under a fresh request id bound
        to the same state (same canonical doc ⇒ same fingerprint ⇒ same
        rows; indices dedupe re-deliveries).  Returns False when the
        outage outlasts the retry budget (jobs then fail visibly)."""
        with self._cond:
            live = [st for st in self._jobs.values() if st.terminal is None]
        try:
            sock = self._connect_with_backoff()
        except ServiceError:
            return False
        with self._cond:
            remapped = {}
            for st in live:
                self._seq += 1
                st.req = f"r{self._seq}"
                st.last_seq = -1
                remapped[st.req] = st
            # Terminal states stay findable under their old reqs; live
            # ones move to their resubmission reqs.
            for req in [r for r, s in self._jobs.items() if s in live]:
                del self._jobs[req]
            self._jobs.update(remapped)
            self._sock = sock
        for st in live:
            try:
                self._send({"op": "submit", "req": st.req, "job": st.doc})
            except ServiceError:
                return True       # reader will see the drop and loop again
        return True

    def _dispatch(self, msg: dict) -> None:
        event = msg.get("event")
        req = msg.get("req")
        with self._cond:
            if event == "stats":
                self._stats[req] = msg["stats"]
                self._cond.notify_all()
                return
            st = self._jobs.get(req)
            if st is None:
                if event == "error":   # rejection of an unknown/bad req
                    pass
                self._cond.notify_all()
                return
            if "seq" in msg:
                st.last_seq = max(st.last_seq, msg["seq"])
            if event == "accepted":
                if st.accepted is None:
                    st.accepted = msg
                elif msg["fingerprint"] != st.accepted["fingerprint"]:
                    # A resumed job must be the *same* job: the canonical
                    # fingerprint is the idempotency contract.
                    st.terminal = "error"
                    st.message = ("resumed job fingerprint mismatch: "
                                  f"{msg['fingerprint']} != "
                                  f"{st.accepted['fingerprint']}")
            elif event == "rows":
                for idx, row in msg["rows"]:
                    st.rows[idx] = row
            elif event in ("done", "cancelled"):
                st.terminal = event
            elif event == "error":
                st.terminal = "error"
                st.message = msg.get("message", "service error")
                if msg.get("overloaded"):
                    st.retry_after_s = msg.get("retry_after_s", 1.0)
            elif event == "cancel_noop":
                pass
            self._cond.notify_all()
