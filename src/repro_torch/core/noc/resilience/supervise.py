"""Worker supervision primitives for the shard engine's fork backend.

The fork backend historically drove its epoch protocol with blocking
``conn.recv()`` calls: a worker that died (OOM kill, preemption) or
wedged (runaway loop, paused cgroup) hung the whole run forever.  This
module provides the pieces that replace that loop:

* :class:`SuperviseConfig` — deadlines and budgets (op deadline, poll
  interval, respawn budget, teardown escalation timeouts);
* :class:`Heartbeat` — a lock-free shared double the worker stamps when
  it starts processing an op, so the parent can tell "slow epoch" from
  "wedged" (the deadline is measured from the later of op send and last
  heartbeat);
* :func:`supervised_recv` — poll-with-deadline receive that raises
  :class:`WorkerDead` the moment the process exits (after draining any
  final reply) and :class:`WorkerWedged` when the deadline passes with
  the process still alive;
* :func:`reap` — teardown escalation: ``join`` politely, ``terminate()``
  (SIGTERM) the stragglers, then ``kill()`` (SIGKILL) anything that
  ignores SIGTERM — a wedged worker cannot outlive its parent;
* :class:`WorkerFailure` — the failure the shard coordinator surfaces,
  naming the worker, the epoch and the reason.

Everything here is simulator-agnostic (processes + pipes only); the
shard backend owns the recovery *policy* — bounded respawn with
deterministic op-log replay, then degradation to in-process execution.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SuperviseConfig:
    """Deadlines and budgets for supervised shard workers.

    ``op_deadline_s`` bounds one epoch op (simulate / reconcile /
    collect) measured from the later of the op send and the worker's
    last heartbeat; generous by default — epochs are sub-second, so 60 s
    only ever triggers on a genuinely wedged or dead-but-undetected
    worker.  ``max_respawns`` is the total respawn budget for one run;
    once spent, the next failure degrades the run to the in-process
    backend (which replays the epoch log and continues — never
    restarts).  ``join_timeout_s`` / ``term_timeout_s`` drive the
    teardown escalation in :func:`reap`.
    """

    op_deadline_s: float = 60.0
    poll_interval_s: float = 0.02
    max_respawns: int = 2
    join_timeout_s: float = 5.0
    term_timeout_s: float = 2.0


class WorkerDead(RuntimeError):
    """The worker process exited without replying."""


class WorkerWedged(RuntimeError):
    """The worker process is alive but produced neither a reply nor a
    heartbeat within the op deadline."""


class WorkerFailure(RuntimeError):
    """A supervised worker failed beyond recovery; names the worker, the
    epoch it was executing and why — the shard coordinator catches this
    to degrade to in-process execution."""

    def __init__(self, worker: int, epoch: int, reason: str):
        self.worker = worker
        self.epoch = epoch
        self.reason = reason
        super().__init__(
            f"shard worker {worker} failed during epoch {epoch}: {reason}")


class Heartbeat:
    """Lock-free shared timestamp a worker stamps at each op start.

    A plain ``multiprocessing.Value('d', lock=False)``: single-writer
    (the worker), single-reader (the parent), and a torn read at worst
    mis-ages one poll interval — never a correctness hazard.
    """

    __slots__ = ("_v",)

    def __init__(self, ctx):
        self._v = ctx.Value("d", 0.0, lock=False)

    def beat(self) -> None:
        self._v.value = time.monotonic()

    def last(self) -> float:
        return self._v.value


def supervised_recv(conn, proc, cfg: SuperviseConfig,
                    heartbeat: Optional[Heartbeat] = None):
    """Receive one message from ``conn`` under supervision.

    Polls at ``cfg.poll_interval_s``; raises :class:`WorkerDead` when
    ``proc`` has exited (after draining a final in-flight reply, so a
    worker that answered and *then* crashed still counts) and
    :class:`WorkerWedged` when ``cfg.op_deadline_s`` passes without a
    reply or a heartbeat.  ``EOFError``/``OSError`` from a torn pipe
    surface as :class:`WorkerDead` too.
    """
    t_sent = time.monotonic()
    while True:
        try:
            if conn.poll(cfg.poll_interval_s):
                return conn.recv()
        except (EOFError, OSError) as exc:
            raise WorkerDead(f"pipe to pid {proc.pid} broke: {exc!r}") from exc
        if not proc.is_alive():
            try:
                if conn.poll(0):
                    return conn.recv()
            except (EOFError, OSError):
                pass
            raise WorkerDead(
                f"pid {proc.pid} exited with code {proc.exitcode}")
        ref = t_sent
        if heartbeat is not None:
            ref = max(ref, heartbeat.last())
        waited = time.monotonic() - ref
        if waited > cfg.op_deadline_s:
            raise WorkerWedged(
                f"pid {proc.pid} alive but silent for {waited:.1f}s "
                f"(deadline {cfg.op_deadline_s:g}s, last heartbeat "
                f"{'never' if heartbeat is None or heartbeat.last() == 0.0 else f'{time.monotonic() - heartbeat.last():.1f}s ago'})")


def reap(procs, join_timeout_s: float = 5.0,
         term_timeout_s: float = 2.0) -> dict:
    """Tear worker processes down with escalation; returns counts.

    ``join`` up to ``join_timeout_s`` (workers that processed their final
    op exit immediately), then ``terminate()`` (SIGTERM) survivors, then
    ``kill()`` (SIGKILL) anything still alive after ``term_timeout_s`` —
    SIGKILL cannot be ignored, so a wedged or SIGTERM-ignoring worker
    cannot outlive its parent.
    """
    out = {"terminated": 0, "killed": 0}
    for p in procs:
        if p is None:
            continue
        p.join(timeout=join_timeout_s)
    survivors = [p for p in procs if p is not None and p.is_alive()]
    for p in survivors:
        p.terminate()
        out["terminated"] += 1
    for p in survivors:
        p.join(timeout=term_timeout_s)
        if p.is_alive():
            p.kill()
            out["killed"] += 1
            p.join(timeout=term_timeout_s)
    return out
