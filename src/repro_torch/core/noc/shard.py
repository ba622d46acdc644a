"""Region-sharded replay engine: ``engine='shard'``.

Partitions the mesh into a ``gx x gy`` grid of rectangular regions and
runs each region's per-(link, VC) arbitration independently inside
*conservatively bounded epochs*, reconciling boundary links at epoch
edges.  Results are **bit-identical** to ``engine='heap'`` (same
per-stream arrivals, completion cycles and arbitration counter) — the
shard engine is a parallel schedule of exactly the same computation, not
an approximation.

Why this decomposes exactly
---------------------------

* **Links partition by region.**  Every unit (fork group or loose edge)
  has all of its edges share a source tile — chains and join edges are
  single-edge units, and a multicast fork group is the out-edge set of
  one router.  Assigning each unit to the region of its source tile
  therefore assigns each *physical link* to exactly one region, so the
  per-cycle busy set decomposes per region with no cross-region
  arbitration conflicts.

* **Ordering is globally consistent.**  The heap engine processes the
  streams ready at cycle ``t`` in rotated live-position order
  ``(prefix(i) - (rr_base + t)) % n_live``.  Restricted to one region's
  streams this key induces the same relative order, so each region can
  sort its own ready set locally — *provided* ``n_live`` and the live
  positions are constant, which epochs guarantee (below).

* **Epochs freeze all cross-region coupling.**  The only ways regions
  interact are (a) an arrival on a boundary edge enabling a consumer
  unit in another region one router-latency later, (b) a stream
  completing (which shrinks ``n_live``, shifts live positions and
  releases gated streams).  Each epoch ``[t0, T)`` is bounded by
  ``T = 1 + min`` over *permanently valid lower bounds* on (a) the next
  fire of any boundary unit and (b) the completion cycle of any live
  stream.  A bound computed at time tau never becomes invalid — later
  fires are later — it only becomes loose, so bounds are cached in lazy
  min-heaps and refreshed on expiry.  Within an epoch no boundary effect
  or completion can land, so regions simulate independently and
  reconcile at ``T``: boundary arrivals ship to consumer regions,
  completions update the live set / Fenwick positions / gate releases.

  A useful corollary: a boundary unit fires at most once per epoch, at
  exactly ``T - 1`` — the steady-state pipelined regime degenerates to
  1-cycle epochs (cheap messages), while DMA ramps, barrier offsets and
  drained phases are crossed in a single long epoch.

* Bounds for *blocked* units come from a per-fragment relaxation
  (``_Frag.dp_bounds``): earliest-fire estimates propagated along the
  local prereq structure, with remote inputs floored by the producing
  fragment's own scheduled cycle (shipped as per-epoch "null message"
  floors) or by ``t0``.  Looser bounds only shorten epochs; they never
  break equivalence.

Execution backends
------------------

``workers <= 1`` runs every region in-process (the reference schedule).
``workers > 1`` forks persistent worker processes (fork start method —
fragments are inherited copy-on-write, nothing is pickled at setup) and
drives them through a two-round epoch protocol over pipes: round A
simulates ``[t0, T)`` and ships boundary fires; round B applies them,
then reports refreshed bounds for the next epoch.  Workers ship their
owned arrival suffixes once at the end (or on error, so stall reports
match the serial engines).  If worker processes cannot be spawned the
engine warns (naming the exception) and falls back to in-process
execution — results are identical either way.

Supervision and recovery
------------------------

The fork backend is *supervised*: every epoch op is a poll-with-deadline
receive (``resilience.supervise``) against the worker's process liveness
and heartbeat.  A worker that dies (SIGKILL, OOM) or wedges (silent past
the op deadline) is detected and named — worker index, pid, epoch — then
recovered by **respawn + deterministic replay**: the parent's region and
worker-state objects are never mutated while fork workers run, so a
fresh fork child inherits the run's *initial* state, and replaying the
coordinator's op log (every successful ``sim``/``rec`` op) reconstructs
the dead worker's exact region state before the failed op is retried.
The respawn budget is ``SuperviseConfig.max_respawns``; once spent the
run *degrades*: the in-process backend is built over the parent's
pristine regions, the same op log is replayed on it, and the epoch loop
continues from the failed epoch — coordinator progress (completions,
gate releases, reconciliation state) is never rewound.  Retries,
respawns and degradations are reported in ``EngineProfile``.  Teardown
escalates ``join -> terminate -> kill`` so a wedged worker cannot
outlive its parent.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
import os
import signal
import time
import warnings
from typing import TYPE_CHECKING, Optional

from repro_torch.core.noc.engine import stuck_error
from repro_torch.core.noc.resilience.supervise import (
    Heartbeat,
    SuperviseConfig,
    WorkerDead,
    WorkerFailure,
    WorkerWedged,
    reap,
    supervised_recv,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.noc.engine import EngineProfile
    from repro_torch.core.noc.netsim import NoCSim

INF = math.inf


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Region grid + worker processes.  ``grid=None`` picks a square-ish
    grid of about ``workers`` regions clamped to the mesh extents;
    ``workers=None`` defaults to ``min(4, cpu_count)``.  Neither choice
    affects results — only wall-clock.  ``supervise`` overrides the fork
    backend's supervision deadlines/budgets (None = defaults)."""

    grid: Optional[tuple[int, int]] = None
    workers: Optional[int] = None
    supervise: Optional[SuperviseConfig] = None

    def resolve(self, mesh) -> tuple[tuple[int, int], int]:
        workers = self.workers
        if workers is None:
            workers = min(4, os.cpu_count() or 1)
        grid = self.grid
        if grid is None:
            grid = auto_grid(mesh, max(1, workers))
        gx, gy = grid
        if gx < 1 or gy < 1:
            raise ValueError(f"shard grid must be positive, got {grid}")
        gx = min(gx, mesh.cols)
        gy = min(gy, mesh.rows)
        return (gx, gy), max(1, workers)


def auto_grid(mesh, target_regions: int) -> tuple[int, int]:
    """Split the mesh into about ``target_regions`` rectangles, cutting the
    longer extent first so regions stay square-ish."""
    gx = gy = 1
    while gx * gy < target_regions:
        if mesh.cols // gx >= mesh.rows // gy and gx < mesh.cols:
            gx *= 2
        elif gy < mesh.rows:
            gy *= 2
        else:  # mesh exhausted
            break
    return gx, gy


def parse_shard_engine(engine: str) -> ShardConfig:
    """``"shard"`` | ``"shard:GXxGY"`` | ``"shard:GXxGY:W"`` | ``"shard::W"``."""
    parts = engine.split(":")
    if parts[0] != "shard" or len(parts) > 3:
        raise ValueError(f"unknown engine {engine!r}")
    grid = None
    workers = None
    try:
        if len(parts) >= 2 and parts[1]:
            sx, _, sy = parts[1].partition("x")
            grid = (int(sx), int(sy))
        if len(parts) == 3 and parts[2]:
            workers = int(parts[2])
    except ValueError:
        raise ValueError(
            f"malformed shard engine spec {engine!r}; expected "
            "'shard[:GXxGY[:workers]]'"
        ) from None
    return ShardConfig(grid=grid, workers=workers)


# ---------------------------------------------------------------------------
# Fenwick tree over global stream indices (live positions), one per process.
# ---------------------------------------------------------------------------


class _Fenwick:
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


# ---------------------------------------------------------------------------
# Stream fragments
# ---------------------------------------------------------------------------


class _Frag:
    """The units of one stream that live in one region.

    ``recs`` are the *same* compiled ``_uinfo`` records the heap engine
    uses (arrival-list references, integer inject/rate ceilings),
    restricted to the local units; upstream references may point at
    arrival lists owned by another region — those fill up at epoch
    reconciliation (fork backend) or directly (in-process).  The
    ready-list / unit-heap machinery mirrors ``_StreamState`` exactly,
    so a fragment advances beats on precisely the cycles the heap engine
    would.
    """

    __slots__ = (
        "sidx", "n_beats", "recs", "links", "fcount", "final_need",
        "consumers", "gate_t0", "export", "boundary", "uready", "uheap",
        "rlist", "rset", "stream", "gunits", "dpmeta", "dporder",
        "local_done", "dp_cache", "dp_round", "base", "fast", "tfires",
    )

    def __init__(self, sidx, n_beats, recs, links, fcount, consumers,
                 gate_t0, export, boundary, stream, gunits):
        self.sidx = sidx
        self.n_beats = n_beats
        self.recs = recs            # per local unit: tuple of _uinfo records
        self.links = links          # per local unit: tuple of interned ids
        self.fcount = fcount        # per local unit: final edges inside it
        self.final_need = 0         # set by heap_init via _init_final_need
        self.consumers = consumers  # per local unit: tuple of local consumers
        self.gate_t0 = gate_t0      # 0 ungated, None gated-unreleased, int t0
        self.export = export        # per local unit: bid or None
        self.boundary = boundary    # local unit idxs with remote consumers
        self.stream = stream        # owning _StreamState (structure access)
        self.gunits = gunits        # local idx -> global unit idx
        self.uready: list = []
        self.uheap: list = []
        self.rlist: list = []
        self.rset: set = set()
        self.dpmeta = None          # lazy: per (unit, edge) prereq origins
        self.tfires = None          # telemetry: per local unit fire counts
        self.local_done = None      # cycle the local finals drained (if yet)
        self.dp_cache = None        # dp_bounds memo, valid for one round
        self.dp_round = -1
        # Arrival-list lengths at build time: the fork backend ships only
        # the suffixes appended during this run back to the parent.
        self.base = [tuple(len(rec[0]) for rec in recs[li])
                     for li in range(len(recs))]

    # -- final-beat accounting --------------------------------------------

    def _init_final_need(self) -> None:
        """Remaining final-edge arrivals before the *local* finals drain."""
        need = 0
        last = None
        fs = self.stream._finals_set
        for li, fc in enumerate(self.fcount):
            if not fc:
                continue
            unit = self.stream._units[self.gunits[li]]
            for ei, e in enumerate(unit):
                if e in fs:
                    arr = self.recs[li][ei][0]
                    need += self.n_beats - len(arr)
                    if arr and (last is None or arr[-1] > last):
                        last = arr[-1]
        self.final_need = need
        self.local_done = last if need == 0 else None

    # -- readiness (mirrors _StreamState exactly) --------------------------

    def heap_init(self) -> None:
        self._init_final_need()
        # Fast-path records for the dominant unit shapes — chain edges and
        # fork groups whose every edge shares the same single prereq, no
        # inject clock, one uniform rate: (arrival lists, up-arr, rate).
        # All edges of such a unit advance in lockstep from equal lengths,
        # so readiness reduces to the first edge.  Only valid while the
        # gate origin is 0 — the general path covers everything else.
        fast: list = []
        for info in self.recs:
            f = None
            arr0, ups0, inj0, r0 = info[0]
            if (
                inj0 is None and len(ups0) == 1
                and all(
                    inj is None and r_up == r0
                    and tuple(map(id, ups)) == (id(ups0[0]),)
                    and len(arr) == len(arr0)
                    for arr, ups, inj, r_up in info[1:]
                )
            ):
                f = (tuple(rec[0] for rec in info), ups0[0], r0)
            fast.append(f)
        self.fast = fast
        ur: list = []
        heap: list = []
        for li in range(len(self.recs)):
            c = self.unit_next(li)
            ur.append(c)
            if c is not None:
                heap.append((c, li))
        heapq.heapify(heap)
        self.uready = ur
        self.uheap = heap
        self.rlist = []
        self.rset = set()

    def unit_next(self, li: int) -> Optional[int]:
        t0 = self.gate_t0
        f = self.fast[li]
        if f is not None and t0 == 0:
            arrs, ua, r_up = f
            arr = arrs[0]
            b = len(arr)
            if b >= self.n_beats or len(ua) <= b:
                return None
            thr = ua[b] + 1
            if b:
                v = arr[-1] + r_up
                if v > thr:
                    return v
            return thr
        info = self.recs[li]
        b = len(info[0][0])
        if b >= self.n_beats:
            return None
        if len(info) > 1:
            for rec in info:
                if len(rec[0]) != b:
                    return None
        if t0 is None:
            return None
        thr = t0
        for arr, ups, inj, r_up in info:
            for ua in ups:
                if len(ua) <= b:
                    return None
                v = ua[b] + 1
                if v > thr:
                    thr = v
            if inj is not None:
                sn, rn, d = inj
                v = t0 - (-(sn + b * rn) // d)
                if v > thr:
                    thr = v
            if arr:
                v = arr[-1] + r_up
                if v > thr:
                    thr = v
        return thr

    def ready_units(self, t: int) -> list:
        heap = self.uheap
        ur = self.uready
        rset = self.rset
        while heap and heap[0][0] <= t:
            c, li = heapq.heappop(heap)
            if ur[li] == c and li not in rset:
                _insort(self.rlist, li)
                rset.add(li)
        return self.rlist

    def advance_unit(self, li: int, t: int) -> None:
        fastu = self.fast[li]
        if fastu is not None and self.gate_t0 == 0:
            arrs, ua, r_up = fastu
            for arr in arrs:
                arr.append(t)
            nf = self.fcount[li]
            if nf and self.final_need:
                self.final_need -= nf
            b = len(arrs[0])
            if b >= self.n_beats or len(ua) <= b:
                c = None
            else:
                c = ua[b] + 1
                v = t + r_up
                if v > c:
                    c = v
        else:
            for rec in self.recs[li]:
                rec[0].append(t)
            nf = self.fcount[li]
            if nf and self.final_need:
                self.final_need -= nf
            c = self.unit_next(li)
        self.uready[li] = c
        # A unit ready again next cycle stays in the ready list (it is
        # always advanced *from* the list) — no heap churn for the
        # steady-state pipeline; anything else leaves the list and is
        # re-scheduled through the unit heap.
        if c != t + 1:
            if li in self.rset:
                self.rset.remove(li)
                self.rlist.remove(li)
            if c is not None:
                heapq.heappush(self.uheap, (c, li))
        uready = self.uready
        for lj in self.consumers[li]:
            if uready[lj] is None:
                cj = self.unit_next(lj)
                if cj is not None:
                    uready[lj] = cj
                    heapq.heappush(self.uheap, (cj, lj))

    def next_ready(self) -> Optional[int]:
        best: Optional[int] = None
        ur = self.uready
        for li in self.rlist:
            c = ur[li]
            if best is None or c < best:
                best = c
        heap = self.uheap
        while heap:
            c, li = heap[0]
            if ur[li] != c or li in self.rset:
                heapq.heappop(heap)
                continue
            if best is None or c < best:
                best = c
            break
        return best

    def resched(self, li: int) -> None:
        """A remote prereq of ``li`` arrived (or a gate released): re-derive
        its cached cycle if it was blocked — the same invalidation rule
        ``advance_unit`` applies to local consumers."""
        if self.uready[li] is None:
            c = self.unit_next(li)
            if c is not None:
                self.uready[li] = c
                heapq.heappush(self.uheap, (c, li))

    def release(self, t0: int) -> None:
        self.gate_t0 = t0
        for li in range(len(self.recs)):
            self.resched(li)

    # -- lower bounds ------------------------------------------------------

    def _ensure_dpmeta(self) -> None:
        """Per (local unit, edge, prereq): where the prereq arrivals come
        from — ('L', local producer), ('R', bid) for a remote unit, or
        ('X',) for an edge no unit anywhere produces."""
        if self.dpmeta is not None:
            return
        st = self.stream
        owner = {}
        for g, recs in enumerate(st._uinfo):
            for rec in recs:
                owner[id(rec[0])] = g
        glocal = {g: li for li, g in enumerate(self.gunits)}
        meta = []
        for li in range(len(self.recs)):
            per_edge = []
            for rec in self.recs[li]:
                origins = []
                for pa in rec[1]:
                    g = owner.get(id(pa))
                    if g is None:
                        origins.append(("X", 0))
                    elif g in glocal:
                        origins.append(("L", glocal[g]))
                    else:
                        origins.append(("R", (self.sidx, g)))
                per_edge.append(tuple(origins))
            meta.append(tuple(per_edge))
        self.dpmeta = meta
        # Topological order over the local producer -> consumer edges, so
        # the relaxation sees a producer's bound before its consumers (unit
        # construction order is not topological for reduction joins).  Any
        # residue from an (impossible for builder-made streams) local cycle
        # is appended in index order — bounds stay valid, just looser.
        n = len(self.recs)
        indeg = [0] * n
        fwd: list[list[int]] = [[] for _ in range(n)]
        for li in range(n):
            producers = {
                key for per_edge in meta[li] for kind, key in per_edge
                if kind == "L"
            }
            indeg[li] = len(producers)
            for p in producers:
                fwd[p].append(li)
        order = [li for li in range(n) if indeg[li] == 0]
        head = 0
        while head < len(order):
            p = order[head]
            head += 1
            for c in fwd[p]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    order.append(c)
        if len(order) < n:
            seen = set(order)
            order.extend(li for li in range(n) if li not in seen)
        self.dporder = order

    def dp_bounds(self, t0: int, floors: dict) -> list:
        """Earliest-possible next-fire lower bound per local unit.

        Scheduled units use their exact cached cycle; blocked units relax
        over prereqs in local topological order with ``t0`` (or a shipped
        remote floor) as the base for inputs whose bound is unknown.
        Bounds are valid forever (fires only happen later), merely loose.
        """
        self._ensure_dpmeta()
        n = len(self.recs)
        out: list = [None] * n
        nb = self.n_beats
        t0g = self.gate_t0
        for li in self.dporder:
            c = self.uready[li]
            if c is not None:
                out[li] = c
                continue
            info = self.recs[li]
            b = len(info[0][0])
            if b >= nb or t0g is None:
                out[li] = INF
                continue
            thr = t0g
            for (arr, ups, inj, r_up), origins in zip(info, self.dpmeta[li]):
                for pa, origin in zip(ups, origins):
                    lpa = len(pa)
                    if lpa > b:
                        v = pa[b] + 1
                    else:
                        kind, key = origin
                        if kind == "X":
                            thr = INF
                            break
                        if kind == "L":
                            base = out[key]
                            if base is None:  # later in local order
                                base = t0
                        else:
                            base = floors.get(key, t0)
                        if base == INF:
                            thr = INF
                            break
                        v = max(base, t0) + (b - lpa) + 1
                    if v > thr:
                        thr = v
                if thr == INF:
                    break
                if inj is not None:
                    sn, rn, d = inj
                    v = t0g - (-(sn + b * rn) // d)
                    if v > thr:
                        thr = v
                if arr:
                    v = arr[-1] + r_up
                    if v > thr:
                        thr = v
            out[li] = thr
        return out

    def completion_bound(self, dp: list) -> float:
        """Lower bound on this stream's completion from the local finals:
        each local final edge still needs ``n_beats - len(arr)`` fires of
        its unit, spaced at least one cycle apart."""
        if not self.final_need:
            return INF  # local finals drained; other regions carry the bound
        best = None
        nb = self.n_beats
        fs = self.stream._finals_set
        for li, fc in enumerate(self.fcount):
            if not fc:
                continue
            fire = dp[li]
            unit = self.stream._units[self.gunits[li]]
            for ei, e in enumerate(unit):
                if e not in fs:
                    continue
                rem = nb - len(self.recs[li][ei][0])
                if rem <= 0:
                    continue
                v = fire + rem - 1 if fire != INF else INF
                if best is None or v > best:
                    best = v
        return INF if best is None else best


_insort = bisect.insort


def _frag_dp(f: _Frag, t0: int, floors: dict) -> list:
    """Round-cached ``dp_bounds`` (one relaxation per fragment per epoch)."""
    if f.dp_round == t0:
        return f.dp_cache
    dp = f.dp_bounds(t0, floors)
    f.dp_cache = dp
    f.dp_round = t0
    return dp


# ---------------------------------------------------------------------------
# Per-process worker state: live positions shared by a worker's regions.
# ---------------------------------------------------------------------------


class _WorkerState:
    """Round-robin bookkeeping every region needs: the Fenwick tree of live
    positions, the live count and the run's arbitration base.  Built once
    in the parent; fork children inherit identical copies and keep them in
    sync through the broadcast death lists."""

    __slots__ = ("fen", "n_live", "rr_base")

    def __init__(self, n: int, live, rr_base: int):
        self.fen = _Fenwick(n)
        self.n_live = 0
        self.rr_base = rr_base
        for i, alive in enumerate(live):
            if alive:
                self.fen.add(i, 1)
                self.n_live += 1

    def apply_deaths(self, deaths) -> None:
        for sidx in deaths:
            self.fen.add(sidx, -1)
            self.n_live -= 1


# ---------------------------------------------------------------------------
# Region: scheduler + bounds for the fragments whose links it owns.
# ---------------------------------------------------------------------------


class _Region:
    """One rectangular mesh region: a heap-scheduled engine over its
    fragments, bit-identical (within epochs) to the slice of ``run_heap``
    touching this region's links."""

    def __init__(self, rid: int):
        self.rid = rid
        self.frags: list[_Frag] = []
        self.by_sidx: dict[int, int] = {}
        self.link_id: dict = {}
        self.gheap: list = []
        self.sched: list = []
        self.carry: list = []
        self.t = -1
        # Lazy bound heap: entries (value, kind, fidx, li); kind 0 = next
        # fire of boundary unit li, kind 1 = stream completion (li unused).
        self.bheap: list = []
        self.bval: dict = {}
        # bid -> (arrival lists to append, (fidx, local unit) to resched)
        self.cons: dict = {}
        self.n_adv = self.n_push = self.n_pop = self.n_stale = 0

    def intern(self, edge, vc) -> int:
        return self.link_id.setdefault((edge, vc), len(self.link_id))

    # -- run start ---------------------------------------------------------

    def init_run(self, start: int = 0) -> list:
        """Heap-init every fragment; returns pre-drained local finals
        [(sidx, local done)] (only possible when a partially-run stream is
        resumed).  ``start`` is the run's first simulated cycle: readiness
        thresholds recomputed from arrivals can predate it (arbitration
        losers at a pause boundary) and are clamped to it, exactly like
        ``run_heap``'s initial schedule."""
        pre = []
        self.sched = [None] * len(self.frags)
        self.gheap = []
        self.carry = []
        self.t = start - 1
        for fidx, f in enumerate(self.frags):
            f.heap_init()
            if f.local_done is not None and any(f.fcount):
                pre.append((f.sidx, f.local_done))
            c = f.next_ready()
            if c is not None:
                if c < start:
                    c = start
                self.sched[fidx] = c
                self.gheap.append((c, fidx))
            if f.gate_t0 is not None:
                self.refresh_frag(fidx, start, {})
        heapq.heapify(self.gheap)
        return pre

    # -- epoch simulation --------------------------------------------------

    def run_to(self, T: int, max_cycles: int, ws: _WorkerState):
        """Simulate cycles in ``[self.t + 1, T)``; returns (boundary fires,
        drained local finals, timeout flag)."""
        frags = self.frags
        gheap = self.gheap
        sched = self.sched
        fen_prefix = ws.fen.prefix
        rr_base = ws.rr_base
        n_live = ws.n_live
        # Live positions are frozen for the whole epoch (deaths only land
        # at reconciliation), so cache them per fragment: the per-cycle
        # rotated order is then a rotation of one fixed integer order.
        pos = [fen_prefix(f.sidx) for f in frags]
        fires: list = []
        finals: list = []
        timeout = False
        t = self.t
        carry = self.carry
        while True:
            if carry:
                t_next = t + 1
            else:
                t_next = None
                while gheap:
                    c, fi = gheap[0]
                    if sched[fi] != c:
                        heapq.heappop(gheap)
                        self.n_stale += 1
                        continue
                    t_next = c
                    break
                if t_next is None:
                    break
            if t_next >= T or t_next >= max_cycles:
                timeout = t_next >= max_cycles
                for fi in carry:
                    heapq.heappush(gheap, (sched[fi], fi))
                carry = []
                break
            t = t_next
            ready = set(carry)
            carry = []
            while gheap and gheap[0][0] <= t:
                c, fi = heapq.heappop(gheap)
                self.n_pop += 1
                if sched[fi] == c:
                    ready.add(fi)
                else:
                    self.n_stale += 1
            if len(ready) > 1:
                start = (rr_base + t) % n_live
                keyed = sorted((pos[fi], fi) for fi in ready)
                # Rotated live-position order == the legacy pending-list
                # rotation: positions >= start first, wrap-around after.
                cut = bisect.bisect_left(keyed, (start,))
                ordered = [fi for _, fi in keyed[cut:]]
                ordered += [fi for _, fi in keyed[:cut]]
                busy: Optional[set] = set()
            else:
                ordered = ready
                # One stream's units never share a physical link (every
                # edge belongs to exactly one unit), so a lone ready
                # fragment cannot conflict with itself.
                busy = None
            for fi in ordered:
                f = frags[fi]
                lks = f.links
                exp = f.export
                fcount = f.fcount
                tf = f.tfires
                for li in list(f.ready_units(t)):
                    if busy is not None:
                        ls = lks[li]
                        if ls:
                            if not busy.isdisjoint(ls):
                                continue
                            busy.update(ls)
                    f.advance_unit(li, t)
                    self.n_adv += 1
                    if tf is not None:
                        tf[li] += 1
                    bid = exp[li]
                    if bid is not None:
                        fires.append((bid, t))
                    if fcount[li] and f.final_need == 0 and f.local_done is None:
                        f.local_done = t
                        finals.append((f.sidx, t))
                c = f.next_ready()
                if c is None:
                    sched[fi] = None
                elif c <= t + 1:
                    sched[fi] = t + 1
                    carry.append(fi)
                else:
                    sched[fi] = c
                    heapq.heappush(gheap, (c, fi))
                    self.n_push += 1
        self.t = T - 1 if not timeout else t
        self.carry = carry
        return fires, finals, timeout

    def flush_telemetry(self) -> list:
        """Drain this region's per-unit fire counts accumulated since the
        last flush, as picklable ``(stream index, global unit, fires)``
        rows.  Called once per epoch reply: the coordinator folds exactly
        one copy per simulated epoch, and because the flush resets the
        accumulators, replayed epochs (worker recovery / fork-backend
        degradation, whose replies are discarded) recompute deltas that
        are discarded along with the rest of the reply."""
        out = []
        for f in self.frags:
            tf = f.tfires
            if tf is None:
                continue
            gunits = f.gunits
            for li, n in enumerate(tf):
                if n:
                    out.append((f.sidx, gunits[li], n))
                    tf[li] = 0
        return out

    def report_floors(self) -> dict:
        """Per exported boundary unit: a currently valid lower bound on its
        next fire (its exact cached cycle, else the fragment's scheduled
        wake-up) — the 'null messages' consumer regions floor their
        relaxations with."""
        out = {}
        for fidx, f in enumerate(self.frags):
            if not f.boundary:
                continue
            fs = self.sched[fidx]
            for li in f.boundary:
                v = f.uready[li]
                if v is None:
                    v = fs
                if v is not None:
                    out[f.export[li]] = v
        return out

    # -- reconciliation ----------------------------------------------------

    def apply(self, deltas, releases, t0: int, floors: dict) -> None:
        touched = set()
        for bid, cycles, append in deltas:
            cons = self.cons.get(bid)
            if cons is None:
                continue
            arrs, rsl = cons
            if append:
                for arr in arrs:
                    arr.extend(cycles)
            for fidx, li in rsl:
                self.frags[fidx].resched(li)
                touched.add(fidx)
        for sidx, t0v in releases:
            fidx = self.by_sidx.get(sidx)
            if fidx is None:
                continue
            self.frags[fidx].release(t0v)
            self.refresh_frag(fidx, t0, floors)
            touched.add(fidx)
        for fidx in touched:
            c = self.frags[fidx].next_ready()
            if c is None:
                continue
            # next_ready can surface a unit that has been ready (and losing
            # arbitration) since before this epoch; cycles below t0 are
            # already simulated, so the fragment re-enters at t0 — exactly
            # where run_heap's carry path would keep examining it.
            if c < t0:
                c = t0
            if self.sched[fidx] is None or c < self.sched[fidx]:
                self.sched[fidx] = c
                heapq.heappush(self.gheap, (c, fidx))
                self.n_push += 1

    # -- conservative bounds ----------------------------------------------

    def _commit(self, key, v) -> None:
        if self.bval.get(key) != v:
            self.bval[key] = v
            if v != INF:
                heapq.heappush(self.bheap, (v,) + key)

    def refresh_entry(self, key, t0: int, floors: dict) -> None:
        kind, fidx, li = key
        f = self.frags[fidx]
        if f.gate_t0 is None:
            # Unreleased: the coordinator's gate floors own this stream's
            # constraints until release re-creates the entries.
            self._commit(key, INF)
            return
        if kind == 0:
            v = f.uready[li]
            if v is None:
                v = _frag_dp(f, t0, floors)[li]
        else:
            if f.final_need:
                v = f.completion_bound(_frag_dp(f, t0, floors))
            else:
                v = INF
        self._commit(key, v if v == INF else max(v, t0))

    def refresh_frag(self, fidx: int, t0: int, floors: dict) -> None:
        f = self.frags[fidx]
        for li in f.boundary:
            self.refresh_entry((0, fidx, li), t0, floors)
        if any(f.fcount):
            self.refresh_entry((1, fidx, 0), t0, floors)

    def min_bound(self, t0: int, floors: dict) -> float:
        bheap = self.bheap
        bval = self.bval
        while bheap:
            v, kind, fidx, li = bheap[0]
            key = (kind, fidx, li)
            if bval.get(key) != v:
                heapq.heappop(bheap)
                continue
            if v >= t0:
                return v
            heapq.heappop(bheap)
            self.refresh_entry(key, t0, floors)
        return INF

    def gate_lbs(self, wanted, t0: int, floors: dict) -> dict:
        """Completion lower bounds for the wanted gate streams with local
        finals (exact local-done cycles once drained)."""
        out = {}
        for sidx in wanted:
            fidx = self.by_sidx.get(sidx)
            if fidx is None:
                continue
            f = self.frags[fidx]
            if not any(f.fcount):
                continue
            if f.local_done is not None:
                out[sidx] = f.local_done
            elif f.gate_t0 is not None:
                v = f.completion_bound(_frag_dp(f, t0, floors))
                if v != INF:
                    out[sidx] = v
        return out

    def counters(self) -> tuple:
        return (self.n_adv, self.n_push, self.n_pop, self.n_stale)

    def arrival_payload(self) -> tuple:
        """Owned arrival suffixes appended during this run, packed as two
        flat arrays (per-edge lengths + concatenated cycles) — they pickle
        as raw bytes, so shipping a whole region's history back to the
        parent is one memcpy, not hundreds of thousands of objects."""
        from array import array

        lens = array("i")
        flat = array("q")
        for f in self.frags:
            for li, recs in enumerate(f.recs):
                base = f.base[li]
                for ei, rec in enumerate(recs):
                    seg = rec[0][base[ei]:]
                    lens.append(len(seg))
                    flat.extend(seg)
        return lens, flat

    def absorb_payload(self, payload) -> None:
        """Parent-side: extend the real arrival lists with a worker's
        suffixes (the parent's copies were untouched by the fork child)."""
        lens, flat = payload
        i = o = 0
        for f in self.frags:
            for li, recs in enumerate(f.recs):
                for ei, rec in enumerate(recs):
                    n = lens[i]
                    i += 1
                    if n:
                        rec[0].extend(flat[o:o + n])
                        o += n
            f._init_final_need()


# ---------------------------------------------------------------------------
# Build: split every live stream's units into per-region fragments.
# ---------------------------------------------------------------------------


class _CoordState:
    """Parent-side run bookkeeping: completions, gates, boundary routing."""

    def __init__(self, streams):
        self.streams = streams
        self.live = [s.done_cycle is None for s in streams]
        self.n_live = sum(self.live)
        self.done: dict[int, int] = {}
        self.last_completion = -1
        self.pending_final: dict[int, int] = {}
        self.local_done: dict[int, int] = {}
        self.unreleased: set[int] = set()
        self.gate_parents: dict[int, list[int]] = {}
        self.gate_children: dict[int, list[int]] = {}
        self.tails: dict[int, int] = {}
        self.bid_consumers: dict = {}
        self.bid_producer_region: dict = {}
        self.gate_lb_reports: dict[int, float] = {}
        self.initial_finals: list = []


def _build(sim: "NoCSim", grid: tuple[int, int], start: int = 0):
    mesh = sim.mesh
    gx, gy = grid
    cols, rows = mesh.cols, mesh.rows
    streams = sim.streams
    state = _CoordState(streams)
    all_regions = [_Region(r) for r in range(gx * gy)]
    idx_of = {id(s): i for i, s in enumerate(streams)}

    def rid_of(c) -> int:
        x, y = c.x, c.y
        if x < 0:
            x = 0
        elif x >= cols:
            x = cols - 1
        if y < 0:
            y = 0
        elif y >= rows:
            y = rows - 1
        return (y * gy // rows) * gx + (x * gx // cols)

    for sidx, st in enumerate(streams):
        if not state.live[sidx]:
            continue
        st._ensure_units()
        units = st._units
        ureg = [rid_of(u[0][0]) for u in units]
        by_r: dict[int, list[int]] = {}
        for g, r in enumerate(ureg):
            by_r.setdefault(r, []).append(g)
        # Gate state at run start, mirroring _StreamState._t0(): released
        # (with the release origin) when every gate has drained, else
        # pending release by the coordinator.
        if st.gates:
            dones = [g.done_cycle for g in st.gates]
            gate_t0 = None if any(d is None for d in dones) else max(dones) + 1
        else:
            gate_t0 = 0
        state.tails[sidx] = st.n_beats - 1
        if st.gates and gate_t0 is None:
            state.unreleased.add(sidx)
            parents = [idx_of[id(g)] for g in st.gates]
            state.gate_parents[sidx] = parents
            for p in parents:
                state.gate_children.setdefault(p, []).append(sidx)
        frag_at: dict[int, tuple[_Region, _Frag, int, dict]] = {}
        finals_regions = 0
        for r, gunits in sorted(by_r.items()):
            region = all_regions[r]
            lmap = {g: i for i, g in enumerate(gunits)}
            recs = [st._uinfo[g] for g in gunits]
            vc = st.vc
            links = [
                tuple(region.intern(e, vc) for e in st._unit_links[g])
                for g in gunits
            ]
            fcount = [st._unit_final_count[g] for g in gunits]
            if any(fcount):
                finals_regions += 1
            consumers = [
                tuple(lmap[h] for h in st._unit_consumers[g] if ureg[h] == r)
                for g in gunits
            ]
            frag = _Frag(
                sidx, st.n_beats, recs, links, fcount, consumers,
                gate_t0, [None] * len(gunits), [], st, gunits,
            )
            if sim.telemetry is not None:
                frag.tfires = [0] * len(gunits)
            fidx = len(region.frags)
            region.frags.append(frag)
            region.by_sidx[sidx] = fidx
            frag_at[r] = (region, frag, fidx, lmap)
        state.pending_final[sidx] = finals_regions
        if len(by_r) > 1:
            # Boundary wiring: units whose consumers live in other regions.
            for g, r in enumerate(ureg):
                remote = sorted(
                    {ureg[h] for h in st._unit_consumers[g]} - {r}
                )
                if not remote:
                    continue
                bid = (sidx, g)
                preg, pfrag, _, plmap = frag_at[r]
                pl = plmap[g]
                pfrag.export[pl] = bid
                pfrag.boundary.append(pl)
                state.bid_consumers[bid] = tuple(remote)
                state.bid_producer_region[bid] = r
                arrs_of_g = {id(rec[0]): rec[0] for rec in st._uinfo[g]}
                for rr in remote:
                    creg, _, cfidx, clmap = frag_at[rr]
                    arrset: dict = {}
                    rsl = []
                    for h in st._unit_consumers[g]:
                        if ureg[h] != rr:
                            continue
                        rsl.append((cfidx, clmap[h]))
                        for rec in st._uinfo[h]:
                            for pa in rec[1]:
                                if id(pa) in arrs_of_g:
                                    arrset[id(pa)] = pa
                    creg.cons[bid] = (tuple(arrset.values()), tuple(rsl))
    regions = [r for r in all_regions if r.frags]
    for region in regions:
        state.initial_finals.extend(region.init_run(start))
    ws = _WorkerState(len(streams), state.live, sim._rr - start)
    return state, regions, ws


# ---------------------------------------------------------------------------
# Execution backends
# ---------------------------------------------------------------------------

# Test-only chaos hook: schedule exactly one induced worker failure in the
# next fork-backend run.  Injected from the *parent* side (SIGKILL) or as a
# wedge op the child executes (sleep, optionally ignoring SIGTERM), so tests
# can exercise dead- and wedged-worker recovery without reaching into
# subprocess memory.  Fires once, then disarms itself.
_chaos: dict = {}


def set_chaos(kind: Optional[str], worker: int = 0, at_op: int = 0,
              seconds: float = 3600.0, ignore_sigterm: bool = False) -> None:
    """Arm (or with ``kind=None`` disarm) one induced fork-worker failure:
    ``kind='kill'`` SIGKILLs worker ``worker`` just before its op number
    ``at_op`` is sent; ``kind='wedge'`` makes it sleep ``seconds`` at that
    point (optionally ignoring SIGTERM, to exercise the kill escalation)."""
    _chaos.clear()
    if kind is not None:
        _chaos.update(kind=kind, worker=worker, at_op=at_op,
                      seconds=seconds, ignore_sigterm=ignore_sigterm,
                      fired=False)


def _deltas_from_fires(fires_by_bid: dict, state: "_CoordState",
                       worker_of) -> dict:
    """Boundary-fire deltas per consumer region, derived from the raw
    per-bid fire cycles.  ``append`` is backend-specific — True only when
    the consumer region runs in a different process than the producer
    (its arrival-list copies need the cycles appended; same-process
    consumers share the lists physically) — which is why the epoch log
    stores ``fires_by_bid`` and each backend derives its own deltas."""
    deltas_by_region: dict = {}
    for bid, cycles in fires_by_bid.items():
        pw = worker_of(state.bid_producer_region[bid])
        for cr in state.bid_consumers[bid]:
            append = worker_of(cr) != pw
            deltas_by_region.setdefault(cr, []).append((bid, cycles, append))
    return deltas_by_region


def _simulate_regions(regions, T: int, max_cycles: int, ws: _WorkerState) -> dict:
    """Round A for one process's regions: run the epoch, report fires,
    drained finals, timeout flags, boundary floors and flushed telemetry
    deltas per region."""
    return {
        r.rid: r.run_to(T, max_cycles, ws)
        + (r.report_floors(), r.flush_telemetry())
        for r in regions
    }


def _reconcile_regions(regions, ws: _WorkerState, floors: dict,
                       deltas_by_region, deaths, releases, wanted,
                       floor_updates, t0: int):
    """Round B for one process's regions — THE reconciliation semantics,
    shared verbatim by the in-process backend and the fork workers so the
    two schedules cannot drift: apply deaths to the live positions, merge
    floor updates, deliver boundary deltas / gate releases, then report
    refreshed epoch bounds and (max-merged) gate completion lbs."""
    ws.apply_deaths(deaths)
    floors.update(floor_updates)
    minb = {}
    lbs: dict = {}
    for r in regions:
        r.apply(deltas_by_region.get(r.rid, ()), releases, t0, floors)
        minb[r.rid] = r.min_bound(t0, floors)
        for sidx, v in r.gate_lbs(wanted, t0, floors).items():
            if sidx not in lbs or v > lbs[sidx]:
                lbs[sidx] = v
    return minb, lbs


class _InProcBackend:
    """Reference schedule: every region simulated in this process, in
    region-index order.  Arrival lists are physically shared, so boundary
    deltas only reschedule consumers (append=False everywhere)."""

    workers_used = 0
    epoch = 0

    def __init__(self, regions, ws, max_cycles, state):
        self.regions = regions
        self.ws = ws
        self.max_cycles = max_cycles
        self.state = state
        self.floors: dict = {}
        self.recovery: dict = {}

    def worker_of(self, rid: int) -> int:
        return 0

    def simulate(self, T: int) -> dict:
        return _simulate_regions(self.regions, T, self.max_cycles, self.ws)

    def reconcile(self, fires_by_bid, deaths, releases, wanted,
                  floor_updates, t0: int):
        deltas_by_region = _deltas_from_fires(
            fires_by_bid, self.state, self.worker_of)
        return _reconcile_regions(
            self.regions, self.ws, self.floors, deltas_by_region, deaths,
            releases, wanted, floor_updates, t0,
        )

    def collect(self) -> tuple:
        counters = [r.counters() for r in self.regions]
        return counters

    def close(self) -> None:
        pass


def _worker_main(conn, regions, ws, max_cycles, hb=None):  # pragma: no cover - subprocess
    """Fork-child loop: inherited regions + worker state, pipe-driven.
    ``hb`` is the shared heartbeat stamped at each op start so the parent
    can distinguish a slow epoch from a wedged process."""
    import gc

    # The child inherits the parent's whole heap; a GC pass would touch
    # (and copy-on-write fault) every inherited object.  The epoch loop
    # allocates only acyclic data, so collection is pure overhead here.
    gc.freeze()
    gc.disable()
    floors: dict = {}
    try:
        while True:
            msg = conn.recv()
            if hb is not None:
                hb.beat()
            op = msg[0]
            if op == "sim":
                conn.send(_simulate_regions(regions, msg[1], max_cycles, ws))
            elif op == "rec":
                _, deltas_by_region, deaths, releases, wanted, updates, t0 = msg
                conn.send(_reconcile_regions(
                    regions, ws, floors, deltas_by_region, deaths, releases,
                    wanted, updates, t0,
                ))
            elif op == "fin":
                conn.send([
                    (r.rid, r.arrival_payload(), r.counters()) for r in regions
                ])
                break
            elif op == "wedge":  # test-induced hang (see set_chaos)
                _, seconds, ignore_sigterm = msg
                if ignore_sigterm:
                    signal.signal(signal.SIGTERM, signal.SIG_IGN)
                time.sleep(seconds)
            else:
                raise ValueError(f"unknown worker op {op!r}")
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        conn.close()


class _ForkBackend:
    """Persistent fork workers, one pipe each; regions are inherited
    copy-on-write at fork time so setup ships no data.

    Supervised: every reply is a poll-with-deadline ``supervised_recv``
    against the worker's liveness and heartbeat.  Failed workers are
    respawned (fresh fork of the parent's *never-mutated* initial state)
    and rebuilt by replaying the op log — every successful ``sim``/``rec``
    op, each of which is deterministic — then the failed op is retried
    once.  Budget exhaustion or a failed replay raises
    :class:`WorkerFailure`, which the coordinator turns into in-process
    degradation.  ``recovery`` counts retries/respawns for the profile.
    """

    def __init__(self, regions, ws, max_cycles, workers, state,
                 supervise: Optional[SuperviseConfig] = None):
        import multiprocessing as mp

        self._ctx = mp.get_context("fork")
        nw = min(workers, len(regions))
        self.regions = regions
        self.ws = ws
        self.max_cycles = max_cycles
        self.state = state
        self.cfg = supervise or SuperviseConfig()
        self._worker_of = {
            r.rid: i % nw for i, r in enumerate(regions)
        }
        self.conns: list = [None] * nw
        self.procs: list = [None] * nw
        self.hbs: list = [None] * nw
        self.workers_used = nw
        self._collected = None
        # Op log for respawn replay + degradation handoff.  "fin" is never
        # logged (it is idempotent from parent-side absorbed state and must
        # not be replayed into a fresh worker mid-run).
        self.log: list = []
        self._op_count = [0] * nw   # ops sent per worker (chaos addressing)
        self._deltas_key = None     # identity cache for per-worker payloads
        self._deltas_cache = None
        self.recovery = {"worker_retries": 0, "worker_respawns": 0}
        self.epoch = 0              # stamped by the coordinator per epoch
        try:
            for w in range(nw):
                self._spawn(w)
        except BaseException:
            self.close()
            raise

    def worker_of(self, rid: int) -> int:
        return self._worker_of[rid]

    # -- process lifecycle -------------------------------------------------

    def _spawn(self, w: int) -> None:
        regs = [
            r for i, r in enumerate(self.regions)
            if i % self.workers_used == w
        ]
        hb = Heartbeat(self._ctx)
        parent_conn, child_conn = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, regs, self.ws, self.max_cycles, hb),
            daemon=True,
        )
        p.start()
        child_conn.close()
        self.conns[w] = parent_conn
        self.procs[w] = p
        self.hbs[w] = hb

    def _recover(self, w: int, exc: BaseException) -> None:
        """Respawn worker ``w`` and rebuild its state by replaying the op
        log; raises :class:`WorkerFailure` when the respawn budget is spent
        or the replay itself fails."""
        if self.recovery["worker_respawns"] >= self.cfg.max_respawns:
            raise WorkerFailure(
                w, self.epoch,
                f"respawn budget ({self.cfg.max_respawns}) exhausted; "
                f"last failure: {exc!r}",
            ) from exc
        p = self.procs[w]
        warnings.warn(
            f"shard engine: worker {w} (pid {p.pid}) failed during epoch "
            f"{self.epoch} ({exc!r}); respawning and replaying "
            f"{len(self.log)} logged op(s)",
            RuntimeWarning,
            stacklevel=4,
        )
        try:
            self.conns[w].close()
        except OSError:
            pass
        if p.is_alive():
            p.kill()
        p.join(timeout=self.cfg.term_timeout_s)
        self.recovery["worker_respawns"] += 1
        self._spawn(w)
        self._op_count[w] = 0
        for entry in self.log:
            try:
                self._send(w, entry)
                supervised_recv(
                    self.conns[w], self.procs[w], self.cfg, self.hbs[w])
            except (WorkerDead, WorkerWedged, EOFError, OSError) as exc2:
                raise WorkerFailure(
                    w, self.epoch,
                    f"op-log replay after respawn failed: {exc2!r}",
                ) from exc2

    def _retry(self, w: int, entry, exc: BaseException):
        self._recover(w, exc)
        self.recovery["worker_retries"] += 1
        try:
            self._send(w, entry)
            return supervised_recv(
                self.conns[w], self.procs[w], self.cfg, self.hbs[w])
        except (WorkerDead, WorkerWedged, EOFError, OSError) as exc2:
            raise WorkerFailure(
                w, self.epoch,
                f"retry after respawn also failed: {exc2!r}",
            ) from exc2

    # -- op plumbing -------------------------------------------------------

    def _payload(self, w: int, entry):
        """Per-worker wire message for a logged op: ``rec`` entries carry
        raw ``fires_by_bid`` and are specialized into this worker's local
        deltas here (append flags are process-layout-specific)."""
        if entry[0] != "rec":
            return entry
        if self._deltas_key is not entry:
            self._deltas_cache = _deltas_from_fires(
                entry[1], self.state, self.worker_of)
            self._deltas_key = entry
        local = {
            rid: d for rid, d in self._deltas_cache.items()
            if self._worker_of[rid] == w
        }
        return ("rec", local) + entry[2:]

    def _send(self, w: int, entry) -> None:
        ch = _chaos
        if (ch and not ch["fired"] and ch["worker"] == w
                and self._op_count[w] >= ch["at_op"]):
            ch["fired"] = True
            if ch["kind"] == "kill":
                os.kill(self.procs[w].pid, signal.SIGKILL)
                self.procs[w].join(timeout=self.cfg.term_timeout_s)
            elif ch["kind"] == "wedge":
                self.conns[w].send(
                    ("wedge", ch["seconds"], ch["ignore_sigterm"]))
        self.conns[w].send(self._payload(w, entry))
        self._op_count[w] += 1

    def _broadcast(self, entry) -> list:
        send_failed: dict = {}
        for w in range(self.workers_used):
            try:
                self._send(w, entry)
            except (OSError, ValueError) as exc:
                send_failed[w] = exc
        replies: list = [None] * self.workers_used
        for w in range(self.workers_used):
            if w in send_failed:
                replies[w] = self._retry(w, entry, send_failed[w])
                continue
            try:
                replies[w] = supervised_recv(
                    self.conns[w], self.procs[w], self.cfg, self.hbs[w])
            except (WorkerDead, WorkerWedged) as exc:
                replies[w] = self._retry(w, entry, exc)
        if entry[0] != "fin":
            self.log.append(entry)
        return replies

    # -- backend interface -------------------------------------------------

    def simulate(self, T: int) -> dict:
        out: dict = {}
        for reply in self._broadcast(("sim", T)):
            out.update(reply)
        return out

    def reconcile(self, fires_by_bid, deaths, releases, wanted,
                  floor_updates, t0: int):
        entry = ("rec", fires_by_bid, deaths, releases, wanted,
                 floor_updates, t0)
        minb: dict = {}
        lbs: dict = {}
        for mb, lb in self._broadcast(entry):
            minb.update(mb)
            for sidx, v in lb.items():
                if sidx not in lbs or v > lbs[sidx]:
                    lbs[sidx] = v
        return minb, lbs

    def collect(self) -> list:
        """Pull owned arrival suffixes + counters back into the parent's
        region objects (idempotent; also used on the error path so stall
        reports see the simulated frontier)."""
        if self._collected is not None:
            return self._collected
        by_rid = {r.rid: r for r in self.regions}
        counters = []
        for reply in self._broadcast(("fin",)):
            for rid, payload, ctrs in reply:
                by_rid[rid].absorb_payload(payload)
                counters.append(ctrs)
        self._collected = counters
        return counters

    def close(self) -> dict:
        for conn in self.conns:
            if conn is None:
                continue
            try:
                conn.close()
            except OSError:
                pass
        self.conns = [None] * self.workers_used
        stats = reap(
            [p for p in self.procs if p is not None],
            self.cfg.join_timeout_s, self.cfg.term_timeout_s,
        )
        self.procs = [None] * self.workers_used
        return stats


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


def _gated_constraint(state: _CoordState, t0: int):
    """min over unreleased gated streams of a lower bound on their release
    origin (no fire of theirs can precede it), derived topologically from
    their gates' completion bounds."""
    if not state.unreleased:
        return INF
    m = INF
    vals: dict[int, float] = {}

    def parent_lb(p: int) -> float:
        if p in state.done:
            return state.done[p]
        if not state.live[p]:
            return state.streams[p].done_cycle
        if p in state.unreleased:
            return vals.get(p, INF)
        return state.gate_lb_reports.get(p, t0)

    remaining = {
        s: sum(1 for p in state.gate_parents[s] if p in state.unreleased)
        for s in state.unreleased
    }
    queue = [s for s, r in remaining.items() if r == 0]
    seen = 0
    while queue:
        s = queue.pop()
        seen += 1
        floor = 1 + max(parent_lb(p) for p in state.gate_parents[s])
        if floor < m:
            m = floor
        vals[s] = floor + state.tails[s] if floor != INF else INF
        for c in state.gate_children.get(s, ()):
            if c in remaining:
                remaining[c] -= 1
                if remaining[c] == 0:
                    queue.append(c)
    if seen < len(state.unreleased):  # dependency cycle: floor at t0 + 1
        m = min(m, t0 + 1)
    return m


def _process_finals(state: _CoordState, finals):
    """Fold local-final drain reports into completions; returns (deaths,
    releases) to broadcast."""
    deaths = []
    for sidx, local_done in finals:
        prev = state.local_done.get(sidx)
        if prev is None or local_done > prev:
            state.local_done[sidx] = local_done
        state.pending_final[sidx] -= 1
        if state.pending_final[sidx] == 0 and state.live[sidx]:
            done = state.local_done[sidx]
            state.done[sidx] = done
            state.live[sidx] = False
            state.n_live -= 1
            if done > state.last_completion:
                state.last_completion = done
            deaths.append(sidx)
    releases = []
    for sidx in deaths:
        for dep in state.gate_children.get(sidx, ()):
            if dep not in state.unreleased:
                continue
            dones = [
                state.done.get(p, state.streams[p].done_cycle)
                for p in state.gate_parents[dep]
            ]
            if any(d is None for d in dones):
                continue
            state.unreleased.discard(dep)
            releases.append((dep, max(dones) + 1))
    return deaths, releases


def _finalize(sim: "NoCSim", state: _CoordState, rr_base: int,
              start: int = 0, paused_at: Optional[int] = None) -> int:
    """Install completions on the real streams and close the run exactly
    like run_heap: one arbitration slot per cycle examined in this run's
    window.  A paused run consumed exactly ``paused_at - start`` slots
    and returns ``paused_at``; a completed run consumed
    ``last_completion - start + 1``."""
    for sidx, done in state.done.items():
        st = state.streams[sidx]
        st.done_cycle = done
        st.ready_hint = None
    if paused_at is not None:
        sim._rr = rr_base + (paused_at - start)
        return paused_at
    if state.last_completion >= 0:
        sim._rr = rr_base + (state.last_completion - start) + 1
    return max(s.done_cycle for s in sim.streams)


def run_shard(sim: "NoCSim", max_cycles: int, cfg: ShardConfig | None = None,
              prof: "EngineProfile | None" = None,
              stop_at: Optional[int] = None, start: int = 0) -> int:
    """Run ``sim`` under the region-sharded engine.

    Bit-identical to ``engine='heap'``: same arrivals, done cycles and
    ``_rr``, for any region grid and worker count — including paused
    windows (``stop_at``/``start``, see the engine-contract docstring in
    ``engine.py``).  A :class:`WorkerFailure` from the fork backend
    degrades the run to in-process execution that continues from the
    failed epoch (region state rebuilt by op-log replay; coordinator
    progress is never rewound).
    """
    cfg = cfg or ShardConfig()
    streams = sim.streams
    if not any(s.done_cycle is None for s in streams):
        return 0 if not streams else max(s.done_cycle for s in streams)
    grid, workers = cfg.resolve(sim.mesh)
    rr_base = sim._rr
    tel = sim.telemetry
    state, regions, ws = _build(sim, grid, start)
    backend = None
    if workers > 1 and len(regions) > 1:
        try:
            backend = _ForkBackend(
                regions, ws, max_cycles, workers, state, cfg.supervise)
        except Exception as exc:
            warnings.warn(
                f"shard engine: worker processes unavailable ({exc!r}); "
                "falling back to in-process region execution",
                RuntimeWarning,
                stacklevel=2,
            )
    if backend is None:
        backend = _InProcBackend(regions, ws, max_cycles, state)
    if prof is not None:
        prof.regions = len(regions)
        prof.workers = getattr(backend, "workers_used", 0)

    n_epochs = 0
    n_recon = 0
    t0 = start
    minb: dict = {}

    def call(op: str, *args):
        """Backend op with graceful degradation: on WorkerFailure, fall
        back to the in-process backend over the parent's pristine regions,
        replay the fork backend's op log to rebuild region state, then
        re-execute the failed op — the run continues from the failed
        epoch, it does not restart."""
        nonlocal backend
        try:
            return getattr(backend, op)(*args)
        except WorkerFailure as exc:
            warnings.warn(
                f"shard engine: degrading to in-process region execution "
                f"({exc}); replaying {len(backend.log)} epoch op(s) and "
                f"continuing from epoch {n_epochs}",
                RuntimeWarning,
                stacklevel=3,
            )
            recovery = dict(backend.recovery)
            recovery["worker_degradations"] = \
                recovery.get("worker_degradations", 0) + 1
            oplog = backend.log
            backend.close()
            backend = _InProcBackend(regions, ws, max_cycles, state)
            backend.recovery = recovery
            if prof is not None:
                prof.workers = 0
            for entry in oplog:
                if entry[0] == "sim":
                    backend.simulate(entry[1])
                else:
                    backend.reconcile(*entry[1:])
            return getattr(backend, op)(*args)

    def fail(kind: str, cycle: int, flagged=()):
        call("collect")
        stuck = [s for i, s in enumerate(streams) if state.live[i]]
        err = stuck_error(sim, kind, cycle, stuck)
        gx, gy = grid
        cols, rows = sim.mesh.cols, sim.mesh.rows
        lines = [
            f"shard context: epoch {n_epochs}, t0={t0}"
            + (f", flagged by region(s) {sorted(flagged)}" if flagged else "")
        ]
        show = sorted(flagged) if flagged else [r.rid for r in regions]
        by_rid = {r.rid: r for r in regions}
        for rid in show[:8]:
            r = by_rid[rid]
            rx, ry = rid % gx, rid // gx
            x0, x1 = -(-rx * cols // gx), -(-(rx + 1) * cols // gx)
            y0, y1 = -(-ry * rows // gy), -(-(ry + 1) * rows // gy)
            n_stuck = sum(1 for f in r.frags if state.live[f.sidx])
            b = minb.get(rid, INF)
            lines.append(
                f"  region {rid} [x {x0}..{x1 - 1}, y {y0}..{y1 - 1}]: "
                f"{n_stuck} live fragment(s), next-event bound "
                f"{'inf' if b == INF else int(b)}"
            )
        if len(show) > 8:
            lines.append(f"  ... and {len(show) - 8} more region(s)")
        return RuntimeError(str(err) + "\n" + "\n".join(lines))

    paused = False
    try:
        deaths, releases = _process_finals(state, state.initial_finals)
        wanted = sorted({
            p for s in state.unreleased for p in state.gate_parents[s]
        })
        minb, lbs = call(
            "reconcile", {}, deaths, releases, wanted, {}, start)
        state.gate_lb_reports.update(lbs)
        while state.n_live:
            if stop_at is not None and t0 >= stop_at:
                paused = True
                break
            m = min(minb.values(), default=INF)
            mg = _gated_constraint(state, t0)
            if mg < m:
                m = mg
            if m == INF:
                raise fail("deadlock", t0)
            # Epochs always advance time; regions flag the timeout
            # themselves when a pending event sits at or past max_cycles.
            T = max(int(m) + 1, t0 + 1)
            if stop_at is not None and T > stop_at:
                T = stop_at
            backend.epoch = n_epochs + 1
            replies = call("simulate", T)
            n_epochs += 1
            fires_by_bid: dict = {}
            finals: list = []
            flagged: list = []
            floor_updates: dict = {}
            for rid, (fires, rfinals, rtimeout, rfloors,
                      rtel) in replies.items():
                finals.extend(rfinals)
                if rtimeout:
                    flagged.append(rid)
                floor_updates.update(rfloors)
                if tel is not None:
                    # Exactly one fold per simulated epoch: replayed
                    # epochs' replies are discarded before reaching here.
                    for sidx, gu, nf in rtel:
                        tel.add_unit_fires(streams[sidx], gu, nf)
                for bid, tf in fires:
                    fires_by_bid.setdefault(bid, []).append(tf)
            if flagged:
                raise fail("deadlock/timeout", max_cycles, flagged)
            for bid, cycles in fires_by_bid.items():
                cycles.sort()
                n_recon += len(cycles) * len(state.bid_consumers[bid])
            deaths, releases = _process_finals(state, finals)
            if not state.n_live:
                break
            t0 = T
            wanted = sorted({
                p for s in state.unreleased for p in state.gate_parents[s]
            })
            minb, lbs = call(
                "reconcile", fires_by_bid, deaths, releases, wanted,
                floor_updates, t0,
            )
            state.gate_lb_reports.update(lbs)
        counters = call("collect")
        if prof is not None:
            prof.epochs = n_epochs
            prof.boundary_reconciliations = n_recon
            for adv, push, pop, stale in counters:
                prof.advances += adv
                prof.heap_pushes += push
                prof.heap_pops += pop
                prof.lazy_invalidations += stale
            rec = getattr(backend, "recovery", None) or {}
            prof.worker_retries += rec.get("worker_retries", 0)
            prof.worker_respawns += rec.get("worker_respawns", 0)
            prof.worker_degradations += rec.get("worker_degradations", 0)
    finally:
        backend.close()
    return _finalize(sim, state, rr_base, start,
                     stop_at if paused else None)
