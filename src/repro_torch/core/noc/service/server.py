"""Socket front end of the simulation service: AF_UNIX and TCP.

:class:`SimulationServer` listens on an ``AF_UNIX`` socket — and, when
``tcp=`` is given, on a TCP socket as well — and speaks a line-delimited
JSON protocol: one JSON document per ``\\n``-terminated line, both
directions.  Requests:

``{"op": "auth", "token": <shared token>}``
    **TCP connections only, and required first**: a TCP connection is
    unauthenticated until this line arrives and must not submit
    anything before it.  The token is compared in constant time
    (``hmac.compare_digest``); a wrong token, or any other first
    message, is refused with ``{"event": "auth_error", ...}`` and the
    connection closed — *before any job parsing*.  Success replies
    ``{"event": "auth_ok"}``.  AF_UNIX connections are pre-authorized
    by filesystem permissions and skip the handshake.
``{"op": "submit", "req": <id>, "job": <job doc>}``
    Parse and enqueue a job (:func:`~.jobs.job_from_doc` documents).
    Replies stream asynchronously, all tagged with the request id and a
    per-submission monotonic ``seq``:
    ``{"event": "accepted", "req": ..., "seq": 0, "job": ...,
    "rows_total": ..., "groups": [...]}`` first, then any number of
    ``{"event": "rows", "seq": ..., "rows": [[index, row], ...]}`` as
    chunks complete (rows arrive in completion order; indices place
    them), then exactly one terminal ``done`` / ``cancelled`` /
    ``error`` event.  An overloaded (or draining) scheduler rejects
    with ``{"event": "error", "overloaded": true, "retry_after_s": ...,
    ...}`` before anything is enqueued.
``{"op": "cancel", "req": <id of the submit>}``
    Cancel that job; idempotent.
``{"op": "stats", "req": <id>}``
    One ``{"event": "stats", "req": ..., "stats": {...}}`` reply with
    the scheduler's point-exact counters.

Concurrency: every connection gets a reader thread; events are written
under a per-connection lock (scheduler callbacks and reader replies
interleave safely).  A client disconnect cancels all of its live jobs —
queued points nobody else wants are dropped before they cost a slot.

Durability and lifecycle: pass ``store=`` (a path or
:class:`~.store.ResultStore`) and every completed point is written
through to the crash-safe on-disk memo — a server restarted on the same
store serves yesterday's rows as memo hits, bit-identical.
:meth:`SimulationServer.drain` stops accepting connections, lets
accepted jobs finish, flushes the store and closes;
``handle_sigterm=True`` wires that to SIGTERM (main thread only).
:class:`ServerProcess` runs the whole server in a child process for
chaos/restart testing — SIGKILL it mid-stream, restart it on the same
store, and a resilient client completes with zero duplicate compute.

Rows are bit-identical to the direct APIs end to end: JSON float
serialization round-trips exactly (``repr``-based), so the
``SweepPoint`` a client rebuilds equals the one ``saturation_sweep``
returns, field for field.
"""

from __future__ import annotations

import errno
import hmac
import json
import os
import socket
import tempfile
import threading
from typing import Optional

from repro_torch.core.noc.service.scheduler import Scheduler, SchedulerOverloaded


def _unlink_stale_unix_socket(path: str) -> None:
    """Remove a socket file left behind by a killed server, but only if
    nothing is listening on it (probe-connect first)."""
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.settimeout(0.25)
        probe.connect(path)
    except OSError as exc:
        if exc.errno in (errno.ECONNREFUSED, errno.ENOENT):
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        raise
    finally:
        probe.close()
    raise OSError(errno.EADDRINUSE,
                  f"another server is listening on {path}")


class SimulationServer:
    """Persistent simulation service on local and/or TCP sockets.

    Owns a :class:`~.scheduler.Scheduler` (created from the constructor
    knobs unless an existing one is passed) and serves until
    :meth:`close`.  Use as a context manager; ``path`` defaults to a
    fresh socket in a private temp directory.  ``tcp=(host, port)``
    (port 0 for ephemeral — see :attr:`tcp_address`) adds a TCP
    listener guarded by the mandatory shared ``token``.  ``store``,
    ``max_queue_points`` and ``supervise`` pass through to the
    scheduler (durable result store, bounded admission, worker
    teardown/respawn deadlines).
    """

    def __init__(self, path: Optional[str] = None, workers=None,
                 chunk_tokens: int = 8, scheduler: Optional[Scheduler] = None,
                 telemetry=None, backlog: int = 16,
                 tcp: Optional[tuple] = None, token: Optional[str] = None,
                 store=None, max_queue_points: Optional[int] = None,
                 supervise=None, handle_sigterm: bool = False):
        if tcp is not None and not token:
            raise ValueError(
                "a TCP listener requires a shared token (token=...); "
                "refusing to expose an unauthenticated network service")
        self._tmpdir = None
        if path is None:
            self._tmpdir = tempfile.mkdtemp(prefix="repro-noc-service-")
            path = os.path.join(self._tmpdir, "service.sock")
        self.path = path
        self.token = token
        self.scheduler = scheduler or Scheduler(
            workers=workers, chunk_tokens=chunk_tokens, telemetry=telemetry,
            store=store, max_queue_points=max_queue_points,
            supervise=supervise)
        self._owns_scheduler = scheduler is None
        self._lock = threading.Lock()
        self._conns: set = set()
        self._closed = False
        self._draining = False
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._sock.bind(path)
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE:
                raise
            # A SIGKILL'd predecessor leaves its socket file behind; a
            # restart on the same path (the durable-store workflow) must
            # reclaim it — but never steal a live server's socket.
            _unlink_stale_unix_socket(path)
            self._sock.bind(path)
        self._sock.listen(backlog)

        self.tcp_address: Optional[tuple] = None
        self._tcp_sock = None
        if tcp is not None:
            host, port = tcp
            self._tcp_sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._tcp_sock.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._tcp_sock.bind((host, int(port)))
            self._tcp_sock.listen(backlog)
            self.tcp_address = self._tcp_sock.getsockname()[:2]

        if handle_sigterm:
            import signal

            def _on_term(signum, frame):
                # Runs on the main thread; drain and exit cleanly so a
                # supervisor's SIGTERM never loses in-flight rows.
                self.drain()
                self.close()
                raise SystemExit(0)

            signal.signal(signal.SIGTERM, _on_term)

        self._accept_threads = []
        self._conn_seq = 0
        listeners = [("unix", self._sock)]
        if self._tcp_sock is not None:
            listeners.append(("tcp", self._tcp_sock))
        for kind, sock in listeners:
            t = threading.Thread(target=self._accept_loop,
                                 args=(sock, kind),
                                 name=f"service-accept-{kind}", daemon=True)
            t.start()
            self._accept_threads.append(t)

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful drain: stop accepting new connections and jobs, let
        every accepted job reach its terminal event (in-flight chunks
        finish and persist to the store), flush the store, and return
        the scheduler's final stats.  Existing connections stay open so
        clients receive their final events; call :meth:`close` after
        (or rely on ``with``)."""
        with self._lock:
            if self._draining:
                return self.scheduler.stats()
            self._draining = True
        for sock in (self._sock, self._tcp_sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        return self.scheduler.drain(timeout=timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sock in (self._sock, self._tcp_sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.shutdown()
        for t in self._accept_threads:
            t.join(timeout=5)
        if self._owns_scheduler:
            self.scheduler.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass
        if self._tmpdir is not None:
            try:
                os.rmdir(self._tmpdir)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- accept / per-connection machinery ---------------------------------

    def _accept_loop(self, listen_sock, kind: str) -> None:
        while not self._closed and not self._draining:
            try:
                sock, _ = listen_sock.accept()
            except OSError:
                break
            with self._lock:
                self._conn_seq += 1
                n = self._conn_seq
            conn = _Connection(self, sock, name=f"client{n}",
                               needs_auth=(kind == "tcp"))
            with self._lock:
                self._conns.add(conn)
            conn.start()

    def _drop(self, conn: "_Connection") -> None:
        with self._lock:
            self._conns.discard(conn)


class _Connection:
    """One client connection: a reader thread plus a write lock.

    A TCP connection starts unauthenticated (``needs_auth=True``): the
    only acceptable first line is the auth handshake, checked in
    constant time — everything else is refused and the socket closed
    before any job document is parsed.
    """

    def __init__(self, server: SimulationServer, sock, name: str,
                 needs_auth: bool = False):
        self.server = server
        self.sock = sock
        self.name = name
        self.needs_auth = needs_auth
        self._wlock = threading.Lock()
        self._jobs: dict[str, str] = {}   # req id -> scheduler job id
        self._dead = False
        self._thread = threading.Thread(
            target=self._read_loop, name=f"service-{name}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self._dead = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    # -- wire --------------------------------------------------------------

    def send(self, doc: dict) -> None:
        if self._dead:
            return
        data = (json.dumps(doc) + "\n").encode()
        try:
            with self._wlock:
                self.sock.sendall(data)
        except OSError:
            self._dead = True

    def _read_loop(self) -> None:
        buf = b""
        try:
            while not self._dead:
                try:
                    data = self.sock.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        self._handle_line(line)
        finally:
            self._dead = True
            # A vanished client must not hold slots or queue depth:
            # cancel everything it still has live.
            for job_id in list(self._jobs.values()):
                self.server.scheduler.cancel(job_id)
            try:
                self.sock.close()
            except OSError:
                pass
            self.server._drop(self)

    def _check_auth(self, line: bytes) -> None:
        """Constant-time shared-token handshake; anything else on an
        unauthenticated connection closes it without parsing jobs."""
        try:
            msg = json.loads(line)
            op = msg.get("op")
            supplied = msg.get("token")
        except (json.JSONDecodeError, AttributeError):
            op, supplied = None, None
        ok = (op == "auth" and isinstance(supplied, str)
              and self.server.token is not None
              and hmac.compare_digest(supplied.encode(),
                                      self.server.token.encode()))
        if not ok:
            self.send({"event": "auth_error",
                       "message": "authentication required: the first "
                                  "line on a TCP connection must be "
                                  '{"op": "auth", "token": ...} with '
                                  "the shared token"})
            self.shutdown()
            return
        self.needs_auth = False
        self.send({"event": "auth_ok"})

    def _handle_line(self, line: bytes) -> None:
        if self.needs_auth:
            self._check_auth(line)
            return
        try:
            msg = json.loads(line)
            op = msg.get("op")
            req = msg.get("req")
        except (json.JSONDecodeError, AttributeError):
            self.send({"event": "error", "req": None,
                       "message": "malformed request line"})
            return
        if op == "submit":
            self._handle_submit(req, msg.get("job"))
        elif op == "cancel":
            job_id = self._jobs.get(req)
            cancelled = (self.server.scheduler.cancel(job_id)
                         if job_id is not None else False)
            if not cancelled:
                # Already terminal (or unknown): reply so the client
                # never waits on a cancel of a finished job.
                self.send({"event": "cancel_noop", "req": req})
        elif op == "stats":
            self.send({"event": "stats", "req": req,
                       "stats": self.server.scheduler.stats()})
        else:
            self.send({"event": "error", "req": req,
                       "message": f"unknown op {op!r}"})

    def _handle_submit(self, req, job_doc) -> None:
        seq_lock = threading.Lock()
        seq = [0]

        def on_event(event: dict) -> None:
            out = dict(event)
            out["req"] = req
            with seq_lock:
                out["seq"] = seq[0]
                seq[0] += 1
            self.send(out)

        try:
            job_id = self.server.scheduler.submit(
                self.name, job_doc, on_event)
        except SchedulerOverloaded as exc:
            self.send({"event": "error", "req": req, "overloaded": True,
                       "retry_after_s": exc.retry_after_s,
                       "message": f"rejected: {exc}"})
            return
        except (ValueError, TypeError, KeyError) as exc:
            self.send({"event": "error", "req": req,
                       "message": f"rejected: {exc}"})
            return
        self._jobs[req] = job_id


# ---------------------------------------------------------------------------
# Chaos / restart harness: the server as a killable child process.
# ---------------------------------------------------------------------------


def _server_process_main(conn, kwargs: dict) -> None:
    """Child entry: serve until SIGTERM (drain + clean exit) or SIGKILL
    (the crash the durable store exists for)."""
    import signal
    import sys

    srv = SimulationServer(**kwargs)
    done = threading.Event()

    def _on_term(signum, frame):
        srv.drain()
        srv.close()
        done.set()

    signal.signal(signal.SIGTERM, _on_term)
    conn.send({"path": srv.path, "tcp": srv.tcp_address})
    done.wait()
    sys.exit(0)


class ServerProcess:
    """A :class:`SimulationServer` in a child process, for restart and
    chaos testing: SIGKILL it mid-stream (``kill()``), drain it politely
    (``terminate()`` → SIGTERM), restart another on the same socket path
    and store, and verify clients reconnect and complete with zero
    duplicate compute.

    ``chaos_kill_server_after=N`` arms the scheduler's server-kill hook:
    the child SIGKILLs itself right after the Nth completed chunk is
    durably flushed.  Constructor kwargs otherwise mirror
    :class:`SimulationServer` (``path`` should name a stable socket
    location so a restarted server is reachable at the same address).
    """

    def __init__(self, path: str, store=None,
                 chaos_kill_server_after: Optional[int] = None,
                 start_timeout: float = 30.0, **kwargs):
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        parent, child = ctx.Pipe(duplex=False)
        kw = dict(kwargs, path=path, store=store)
        self._chaos = chaos_kill_server_after
        self.proc = ctx.Process(target=self._child_main,
                                args=(child, kw, chaos_kill_server_after),
                                daemon=True)
        self.proc.start()
        child.close()
        if not parent.poll(start_timeout):
            self.proc.kill()
            raise TimeoutError(
                f"server process did not come up within {start_timeout:g}s")
        ready = parent.recv()
        parent.close()
        self.path = ready["path"]
        self.tcp_address = ready["tcp"]

    @staticmethod
    def _child_main(conn, kwargs: dict, chaos: Optional[int]) -> None:
        if chaos is None:
            _server_process_main(conn, kwargs)
            return
        import sys

        srv = SimulationServer(**kwargs)
        srv.scheduler.chaos_kill_server_after = chaos
        conn.send({"path": srv.path, "tcp": srv.tcp_address})
        threading.Event().wait()   # the chaos hook SIGKILLs us
        sys.exit(0)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        """SIGKILL — the crash the durable store must survive."""
        self.proc.kill()

    def terminate(self) -> None:
        """SIGTERM — graceful drain (stop accepting, finish in-flight,
        flush the store, exit 0)."""
        self.proc.terminate()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        self.proc.join(timeout=timeout)
        return self.proc.exitcode

    def stop(self) -> Optional[int]:
        """Terminate and reap (kill if SIGTERM is ignored)."""
        from repro_torch.core.noc.resilience.supervise import reap

        reap([self.proc])
        return self.proc.exitcode

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
