"""Execution engines for the flit-level NoC simulator.

The original ``NoCSim.run()`` advanced global time one cycle per Python
loop iteration.  That is fine for a 4x4 micro-benchmark but hopeless for
saturation sweeps: a DMA round-trip alone is ~50 idle cycles per stream,
and trace replays of barrier-separated phases spend most of their cycles
with *no* beat eligible to move anywhere.

Two accelerated engines keep the per-cycle arbitration semantics
**bit-identical** (same round-robin start offset, same busy-link set,
same within-cycle request ordering) to the legacy loop.  All three
arbitrate one beat per (physical link, virtual channel) per cycle —
streams carry a ``vc`` assigned from their traffic class (or packet id)
by ``NoCParams.vc_of``, so collective and unicast classes stop blocking
each other head-of-line once ``num_vcs > 1``, while ``num_vcs=1``
reproduces the historical whole-link arbitration exactly:

``run_event_driven``
    Fast-forwards over idle gaps: whenever a cycle ends with no beat
    having crossed any edge, time jumps to the minimum per-stream
    readiness threshold.  Still O(streams) per active cycle — every
    pending stream is scanned, and ``requests()`` re-walks a stream's
    whole edge set.

``run_heap``
    The hot path for large meshes.  Pending streams live in a global
    min-heap keyed on their *exact* next-ready cycle (the same integer
    thresholds ``_StreamState._ready_after`` solves), so a cycle touches
    only the streams that can actually move.  Invariants:

    * **Lazy invalidation** — heap entries are never removed in place; an
      entry is valid only while it matches the stream's currently
      scheduled cycle (``sched``), and stale entries are dropped on pop.
      Within a stream, the per-unit heap uses the same discipline against
      the cached ``_unit_ready`` cycles.
    * **Round-robin tie-breaking** — the legacy loop rotates the pending
      list by ``rr % len(pending)`` each cycle and consumes one counter
      slot per cycle (idle or not).  The heap engine reproduces this
      exactly: a Fenwick tree maintains each stream's *live position*
      (its index in the pending list the legacy loop would have built),
      ready streams are processed in rotated live-position order, and the
      arbitration counter is advanced by the final cycle count on exit —
      so same-cycle entries fire in the identical order and results are
      bit-identical, arbitration counter included.
    * **Incremental readiness** — streams expose ``ready_units`` /
      ``advance_unit`` frontier cursors; an advance dirties only the unit
      itself and its downstream consumer units, never the full edge walk.

``noc.shard`` adds a fourth bit-identical engine on top of these
invariants: ``engine='shard'`` partitions the mesh into rectangular
regions (links partition cleanly because every unit's edges share a
source tile) and runs each region's per-(link, VC) arbitration
independently inside conservatively bounded epochs, reconciling
boundary arrivals, completions and gate releases at epoch edges —
serially or on fork-worker processes.  See the ``shard`` module
docstring for the exactness argument.

Cross-stream *gates* (``_StreamState.gates``) are the engines' only
inter-stream dependency mechanism: a gated stream's inject clock starts
the cycle after its last gate stream drains.  They were introduced for
sliding-window trace replay and are now the lowering target of the
program IR's per-op dependency edges (``noc.program.run_program
(mode='op')``), including the link-free timed streams that ComputeOp /
BarrierOp nodes lower to — all three engines handle gate release
identically (``gate_dependents`` + ``gate_released``).

If no pending stream has a finite readiness threshold the network can
never progress again; all engines raise immediately with a per-stream
stall report (which streams are stuck, their final-edge frontier beats,
and the blocking edges) instead of spinning to ``max_cycles``.

Pause / resume contract (checkpoint substrate)
----------------------------------------------

Every engine accepts a half-open simulation window ``[start, stop_at)``
(``NoCSim.run(stop_at=..., start_cycle=...)``).  A run paused at cycle
``C`` and resumed with ``start_cycle=C`` is **bit-identical** to an
uninterrupted run — same arrivals, done cycles and ``_rr`` — because:

* One arbitration slot is consumed per cycle in the window, idle gaps
  included: a paused engine leaves ``_rr = rr_base + (C - start)``, so
  the rotation key at absolute cycle ``t`` is always
  ``(rr_base_0 + t) % n_live`` regardless of where the run was split.
* Readiness thresholds recomputed from arrivals on resume can predate
  ``C`` (arbitration losers whose beat was ready before the pause);
  engines clamp the initial schedule to ``max(threshold, start)`` —
  those cycles were already simulated, the stream just kept losing.
* Gate origins (``_t0``), completion counters and heap caches are all
  derived from arrivals/done cycles, never from wall state, so
  ``_heap_init`` / ``_Region.init_run`` rebuild them exactly.

``resilience/checkpoint.py`` serializes exactly the state this contract
depends on — per-stream arrival lists, done cycles, gate wiring, exact
Fraction inject/rate schedules, provenance, and sim-level ``_rr`` /
``_pkt_seq`` / fault counters / CDG dependencies — as a versioned,
sha256-fingerprinted JSON document (format ``repro-noc-checkpoint``,
see that module).  ``restore()`` rebuilds streams through the plain
``_StreamState`` constructor, so a resumed run re-derives every cache
from the serialized ground truth.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import TYPE_CHECKING, Optional, Sequence

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from repro_torch.core.noc.netsim import NoCSim, _StreamState


@dataclasses.dataclass
class EngineProfile:
    """Lightweight engine counters from ``NoCSim.run(profile=True)``.

    The data needed to tune the heap/shard hot paths — how much scheduler
    churn a scenario causes (heap pushes/pops, lazily dropped stale
    entries) and, for the shard engine, how the epoch protocol behaved
    (epoch count, boundary arrivals reconciled across regions) — which is
    what region-size tuning reads.  Counters that do not apply to the
    engine that ran stay 0.
    """

    engine: str = "heap"
    makespan: int = 0
    advances: int = 0              # beats advanced (units fired)
    heap_pushes: int = 0           # global scheduler heap pushes
    heap_pops: int = 0             # global scheduler heap pops
    lazy_invalidations: int = 0    # stale entries dropped on pop
    epochs: int = 0                # shard: bounded epochs executed
    boundary_reconciliations: int = 0  # shard: boundary arrivals shipped
    regions: int = 0               # shard: region count
    workers: int = 0               # shard: worker processes used (0=serial)
    # Fault-injection counters (0 on a pristine mesh): accumulated at
    # stream construction time by NoCSim and copied here so degraded runs
    # are observable in run(profile=True) output and bench rows.
    retries_paid: int = 0          # beat crossings that paid a flaky retry
    detoured_routes: int = 0       # unicasts re-routed around dead elements
    regrafted_trees: int = 0       # fork/join trees rebuilt around faults
    # Resilience counters: shard worker supervision (recoveries during a
    # fork-backend run) and mid-run fault arrival (timeline events applied
    # between run segments, streams re-lowered or dropped by them).
    worker_retries: int = 0        # shard: ops retried after a worker failure
    worker_respawns: int = 0       # shard: workers respawned (log replay)
    worker_degradations: int = 0   # shard: fork -> in-process degradations
    fault_events: int = 0          # mid-run FaultTimeline events applied
    relowered_streams: int = 0     # live streams re-lowered at a fault event
    dropped_streams: int = 0       # live streams dropped (dead endpoint)

    def counters(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("engine")
        d.pop("makespan")
        return d

    def absorb(self, seg: "EngineProfile") -> None:
        """Fold one run segment's profile into this accumulator (used by
        checkpointed / timeline runs, which split one logical run into
        several ``run()`` calls).  Additive by default — every counter
        not named in an exclusion set sums across segments, so a newly
        added field folds correctly without touching this method.
        ``ABSORB_LATEST`` fields take the latest segment's value
        (makespan, plus the sim-cumulative fault/resilience counters that
        ``NoCSim._fault_counts`` already accumulates across calls);
        ``ABSORB_MAX`` fields keep the peak; ``ABSORB_SKIP`` fields are
        handled explicitly below."""
        for f in dataclasses.fields(self):
            k = f.name
            if k in ABSORB_SKIP:
                continue
            if k in ABSORB_LATEST:
                setattr(self, k, getattr(seg, k))
            elif k in ABSORB_MAX:
                setattr(self, k, max(getattr(self, k), getattr(seg, k)))
            else:
                setattr(self, k, getattr(self, k) + getattr(seg, k))
        self.engine = seg.engine


# absorb() exclusion sets: fields that do NOT sum across run segments.
# Latest-wins: makespan plus the counters NoCSim._fault_counts already
# accumulates sim-side across run() calls (summing would double-count).
ABSORB_LATEST = frozenset({
    "makespan", "retries_paid", "detoured_routes", "regrafted_trees",
    "fault_events", "relowered_streams", "dropped_streams",
})
# Peak-wins: configuration extents, not work counters.
ABSORB_MAX = frozenset({"regions", "workers"})
# Non-numeric / handled explicitly in absorb().
ABSORB_SKIP = frozenset({"engine"})


def gate_dependents(streams: Sequence["_StreamState"]) -> dict[int, list["_StreamState"]]:
    """Map ``id(gate stream) -> [streams gated on it]`` (window replay)."""
    deps: dict[int, list] = {}
    for s in streams:
        for g in s.gates:
            deps.setdefault(id(g), []).append(s)
    return deps


def stuck_error(sim: "NoCSim", kind: str, t: int, stuck: Sequence["_StreamState"]) -> RuntimeError:
    """Build the deadlock/timeout error: name the stuck streams, their
    final-edge frontier beats and the blocking edges, not just the cycle.

    With faults active the report additionally names the faulted
    links/routers adjacent to the stuck frontier and says so in the
    headline — distinguishing "deadlocked" from "destination unreachable
    under current faults" at a glance."""
    idx = {id(s): i for i, s in enumerate(sim.streams)}
    faults = getattr(sim, "faults", None)
    lines = []
    for s in stuck[:4]:
        lines.append(f"  stream#{idx.get(id(s), '?')}: {s.stall_report()}")
    more = len(stuck) - 4
    if more > 0:
        lines.append(f"  ... and {more} more stuck stream(s)")
    if faults is not None:
        frontier = {c for s in stuck for e in s.edges() for c in e}
        implicated = faults.implicated(frontier)
        lines.append(f"  faults active ({faults.describe()})")
        if implicated:
            lines.append(
                "  implicated at the stuck frontier: "
                + "; ".join(implicated[:6]))
    else:
        lines.append("  no faults active")
    detail = "\n".join(lines)
    return RuntimeError(
        f"netsim {kind} at cycle {t}"
        f"{' under active faults' if faults is not None else ''}: "
        f"{len(stuck)} of {len(sim.streams)} stream(s) cannot advance\n{detail}"
    )


def run_event_driven(sim: "NoCSim", max_cycles: int,
                     stop_at: Optional[int] = None, start: int = 0) -> int:
    """Advance ``sim`` until all streams complete; returns last done cycle.

    Produces exactly the same per-stream arrival times and completion
    cycles as the legacy one-iteration-per-cycle loop.  With ``stop_at``
    the engine simulates cycles in ``[start, stop_at)`` only and returns
    ``stop_at`` when streams remain — the pause/resume contract in the
    module docstring.
    """
    dependents = gate_dependents(sim.streams)
    tel = getattr(sim, "telemetry", None)
    t = start
    limit = max_cycles if stop_at is None else min(max_cycles, stop_at)
    while t < limit:
        pending = [s for s in sim.streams if s.done_cycle is None]
        if not pending:
            break
        busy: set = set()  # (physical link, VC) pairs claimed this cycle
        progressed = False
        start = sim._rr_next() % len(pending)
        for s in pending[start:] + pending[:start]:
            # Skip streams whose cached hint proves they cannot move yet;
            # requests() on them would walk every edge just to return [].
            hint = s.ready_hint
            if hint is not None and t < hint:
                continue
            reqs = s.requests(t)
            if not reqs:
                c = s.next_ready_cycle()
                s.ready_hint = math.inf if c is None else max(c, t + 1)
                continue
            vc = s.vc
            for group in reqs:
                links = [e for e in group if e[0] != e[1]]
                if any((e, vc) in busy for e in links):
                    continue
                busy.update((e, vc) for e in links)
                s.advance(group, t)  # resets the stream's ready_hint
                progressed = True
                if tel is not None:
                    tel.count_group(s, group)
            if s.done_cycle is not None:
                for dep in dependents.get(id(s), ()):
                    dep.gate_released()  # resets the dependent's ready_hint
        if progressed:
            t += 1
            continue
        # Idle cycle: jump to the earliest cycle any stream could advance.
        # Every pending stream now carries a hint (set above or still valid).
        nxt = math.inf
        for s in pending:
            hint = s.ready_hint
            if hint is None:  # ready at t but lost every link arbitration
                nxt = t + 1
                break
            nxt = min(nxt, hint)
        if nxt == math.inf:
            raise stuck_error(sim, "deadlock", t, pending)
        nxt = min(max(int(nxt), t + 1), limit)  # never skip past the window
        sim._rr_skip(nxt - t - 1)  # idle cycles still consume arbitration slots
        t = nxt
    unfinished = [s for s in sim.streams if s.done_cycle is None]
    if unfinished:
        if stop_at is not None and stop_at <= max_cycles:
            return stop_at  # paused at the window boundary, not stuck
        raise stuck_error(sim, "deadlock/timeout", t, unfinished)
    if not sim.streams:
        return 0
    return max(s.done_cycle for s in sim.streams)


class _Fenwick:
    """Binary indexed tree over original stream indices; 1 = still pending.

    ``prefix(i)`` = number of live streams with index < i = the stream's
    position in the pending list the legacy engine would have built, which
    is what the round-robin rotation is defined over.
    """

    __slots__ = ("n", "tree")

    def __init__(self, n: int):
        self.n = n
        self.tree = [0] * (n + 1)

    def add(self, i: int, delta: int) -> None:
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & -i

    def prefix(self, i: int) -> int:
        s = 0
        while i > 0:
            s += self.tree[i]
            i -= i & -i
        return s


def run_heap(sim: "NoCSim", max_cycles: int,
             prof: Optional[EngineProfile] = None,
             stop_at: Optional[int] = None, start: int = 0) -> int:
    """Heap-scheduled engine: bit-identical to the per-cycle loop, but a
    cycle only ever touches the streams whose exact next-ready threshold
    has been reached (plus carried arbitration losers).  ``[start,
    stop_at)`` windows the simulated cycles (pause/resume contract, see
    module docstring): the rotation key at absolute cycle ``t`` is
    ``(rr_base + t - start) % n_live`` and a paused run leaves
    ``_rr = rr_base + (stop_at - start)``."""
    streams = sim.streams
    n = len(streams)
    live = [s.done_cycle is None for s in streams]
    n_live = sum(live)
    if n_live == 0:
        if not streams:
            return 0
        return max(s.done_cycle for s in streams)

    dependents = gate_dependents(streams)
    dep_idx: dict[int, list[int]] = {}
    if dependents:
        pos_of = {id(s): i for i, s in enumerate(streams)}
        dep_idx = {
            pos_of[gid]: [pos_of[id(d)] for d in ds]
            for gid, ds in dependents.items()
            if gid in pos_of
        }

    fen = _Fenwick(n)
    gheap: list[tuple[int, int]] = []   # (next-ready cycle, stream index)
    sched: list = [None] * n            # lazy-invalidation: entry valid iff
                                        # its cycle == sched[stream index]
    # Busy-link arbitration interns each (physical link, VC) pair as a
    # small int so the inner busy-set tests never hash Coord tuples.
    # Streams in different VCs intern disjoint ids for the same link and
    # therefore never collide; with num_vcs=1 the partition is identical
    # to the historical whole-link interning.
    link_id: dict = {}
    linkids: list = [None] * n          # per stream: per unit, tuple of ids
    # Telemetry stays out of the hot loop: per-unit fire counts go into
    # flat arrays and fold into the collector once at run exit.
    tel = getattr(sim, "telemetry", None)
    tfires: list = [None] * n
    for i, s in enumerate(streams):
        if not live[i]:
            continue
        fen.add(i, 1)
        s._heap_init()
        vc = s.vc
        linkids[i] = [
            tuple(
                link_id.setdefault((e, vc), len(link_id)) for e in links
            )
            for links in s._unit_links
        ]
        if tel is not None:
            tfires[i] = [0] * len(s._units)
        c = s.next_ready()
        if c is not None:
            if c < start:
                c = start  # ready before the resume point: cycles < start
                           # were already simulated (arbitration losses)
            sched[i] = c
            gheap.append((c, i))
    heapq.heapify(gheap)

    rr_base = sim._rr
    t = start - 1   # last processed cycle
    carry: list[int] = []  # streams still ready after losing arbitration at t
    n_adv = n_pop = n_stale = 0
    n_push = len(gheap)  # initial population counts as pushes
    paused = False
    while n_live:
        if carry:
            t_next = t + 1
        else:
            t_next = None
            while gheap:
                c, i = gheap[0]
                if not live[i] or sched[i] != c:
                    heapq.heappop(gheap)  # stale (lazy invalidation)
                    n_stale += 1
                    continue
                t_next = c
                break
            if t_next is None:
                raise stuck_error(
                    sim, "deadlock", t + 1,
                    [s for i, s in enumerate(streams) if live[i]],
                )
        if stop_at is not None and t_next >= stop_at and stop_at <= max_cycles:
            paused = True
            break
        if t_next >= max_cycles:
            raise stuck_error(
                sim, "deadlock/timeout", max_cycles,
                [s for i, s in enumerate(streams) if live[i]],
            )
        t = t_next

        ready = set(carry)
        carry = []
        while gheap and gheap[0][0] <= t:
            c, i = heapq.heappop(gheap)
            n_pop += 1
            if live[i] and sched[i] == c:
                ready.add(i)
            else:
                n_stale += 1
        # Rotated live-position order == the legacy pending-list rotation.
        rot = (rr_base + t - start) % n_live
        ordered = sorted(
            ready, key=lambda i: (fen.prefix(i) - rot) % n_live
        )
        busy: set = set()
        finished: list[int] = []
        for i in ordered:
            s = streams[i]
            lids = linkids[i]
            tf = tfires[i]
            for ui in list(s.ready_units(t)):
                links = lids[ui]
                if any(e in busy for e in links):
                    continue
                busy.update(links)
                s.advance_unit(ui, t)
                n_adv += 1
                if tf is not None:
                    tf[ui] += 1
            if s.done_cycle is not None:
                finished.append(i)
                continue
            c = s.next_ready()
            if c is None:
                sched[i] = None       # blocked until a gate stream drains
            elif c <= t + 1:
                sched[i] = t + 1      # still ready (or ready again) next cycle
                carry.append(i)
            else:
                sched[i] = c
                heapq.heappush(gheap, (c, i))
                n_push += 1
        for i in finished:
            live[i] = False
            sched[i] = None
            fen.add(i, -1)
            n_live -= 1
            for d in dep_idx.get(i, ()):
                if not live[d]:
                    continue
                sd = streams[d]
                if any(g.done_cycle is None for g in sd.gates):
                    continue
                sd.gate_released()
                c = sd.next_ready()
                if c is not None and (sched[d] is None or c < sched[d]):
                    sched[d] = c
                    heapq.heappush(gheap, (c, d))
                    n_push += 1
    # One arbitration slot per cycle examined, exactly like the legacy
    # loop (idle gaps included): cycles start..t inclusive — or the whole
    # window [start, stop_at) on pause, trailing idle cycles included, so
    # a resume continues the counter exactly where an uninterrupted run
    # would stand at stop_at.
    if paused:
        sim._rr = rr_base + (stop_at - start)
    else:
        sim._rr = rr_base + (t - start) + 1
    if tel is not None:
        for i, tf in enumerate(tfires):
            if tf is not None:
                tel.add_stream_fires(streams[i], tf)
    if prof is not None:
        prof.advances += n_adv
        prof.heap_pushes += n_push
        prof.heap_pops += n_pop
        prof.lazy_invalidations += n_stale
    if paused:
        return stop_at
    return max(s.done_cycle for s in streams)
