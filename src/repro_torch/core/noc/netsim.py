"""Flit-level cycle simulator of the collective-capable 2-D mesh NoC.

A compact wormhole-style simulator standing in for the paper's
cycle-accurate RTL simulation (Section 4.2).  It models:

* per-(link, VC) occupancy (one beat per link per virtual channel per
  cycle, 64 B beats; ``NoCParams.num_vcs=1`` reduces to whole-link
  occupancy), with each stream assigned the VC of its traffic class,
* policy-routed unicast bursts (``NoCParams.routing``: XY reference,
  YX, O1TURN, odd-even — see ``noc/routing``) with DMA round-trip
  injection latency ``alpha``,
* multicast *fork* semantics of the extended ``xy_route_fork`` +
  ``stream_fork`` (Section 3.1.2): a beat is accepted only when **all**
  selected output links are ready, and forks advance in lockstep,
* reduction *join* semantics of the wide-reduction router (Section 3.1.4):
  a joined beat leaves a router only when the corresponding beat of every
  selected input has arrived, and a router with ``f`` inputs sustains one
  fully-reduced beat per ``f - 1`` cycles (a single two-input wide
  reduction unit per router) — reproducing the paper's observed 1.9x 2-D
  reduction slowdown,
* barrier traffic: serialized 3-cycle read-modify-write atomics for the
  software barrier vs. in-network ``LsbAnd`` joins for the hardware one.

The simulator is used to validate the analytical models of ``model.py``
(the paper validates its models against RTL measurements the same way).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from fractions import Fraction
from typing import Optional, Sequence

from repro_torch.core.noc.engine import run_event_driven, run_heap
from repro_torch.core.noc.faults.regraft import fork_tree_degraded, join_tree_degraded
from repro_torch.core.noc.faults.repair import (
    escape_vc as _escape_vc_of,
    repair_route,
    verify_route_deps,
)
from repro_torch.core.noc.params import NoCParams
from repro_torch.core.noc.routing import fork_tree, get_policy, join_tree
from repro_torch.core.noc.routing.turns import route_turns
from repro_torch.core.topology import Coord, Mesh2D, MultiAddress

Edge = tuple[Coord, Coord]  # (from_node, to_node); from==to encodes local inject/eject


def _frac(v) -> Fraction:
    """Exact cycle quantity.  ``Fraction(float)`` is the exact binary value,
    so float-typed call sites convert losslessly and every engine computes
    the same integer readiness thresholds (no ulp drift across long storms,
    unlike the former ``start + b * rate`` float accumulation)."""
    return v if isinstance(v, Fraction) else Fraction(v)


@dataclasses.dataclass
class _StreamState:
    """Generic beat-DAG stream.

    ``prereqs[e]``  — upstream edges whose beat b must have crossed before
                      beat b may cross e (with >= 1 cycle of router latency).
    ``groups``      — lists of edges that must cross together (fork sets).
    ``rate[e]``     — minimum cycles between consecutive beats on e.
    ``inject[e]``   — (start_cycle, rate): source-side availability of beats.
    ``finals``      — edges whose completion terminates the stream.
    ``gates``       — other streams that must fully drain before any edge of
                      this stream becomes ready; the effective time origin of
                      the inject schedule is then ``max(gate done) + 1``
                      (window-mode trace replay: phase k+1 injects as soon
                      as its phase-k source streams drain).

    All rate/inject quantities are stored as exact :class:`Fraction` cycle
    values; readiness thresholds are exact integer ceilings of the same
    inequalities, so the per-cycle, event-driven and heap engines agree
    bit-for-bit by construction.

    Readiness is evaluated two ways over the same *unit* list (fork groups
    in construction order, then loose prereq-only edges):

    * :meth:`requests` / :meth:`next_ready_cycle` recompute per call — the
      reference semantics used by the ``cycle`` and ``event`` engines;
    * the incremental API (:meth:`ready_units` / :meth:`advance_unit` /
      :meth:`next_ready`) keeps a per-unit frontier cursor and cached
      next-ready cycle, invalidating only the advanced unit and its
      downstream consumers — the hot path of the ``heap`` engine, which
      never re-walks the full edge set on an active cycle.
    """

    n_beats: int
    prereqs: dict[Edge, list[Edge]]
    groups: list[list[Edge]]
    rate: dict[Edge, Fraction]
    inject: dict[Edge, tuple[Fraction, Fraction]]
    finals: list[Edge]
    arrivals: dict[Edge, list[int]] = dataclasses.field(default_factory=dict)
    done_cycle: Optional[int] = None
    # Earliest cycle this stream could possibly advance, given its current
    # arrivals.  Readiness depends only on *intra-stream* state (prereq
    # arrivals, inject schedule, rate spacing, gate completion) — other
    # streams interact solely by blocking links within a cycle — so the
    # hint stays valid until this stream itself advances (or a gate stream
    # completes, which the engines invalidate explicitly).  None =
    # unknown/dirty; ``math.inf`` = blocked until an own advance (or
    # forever).
    ready_hint: Optional[float] = None
    gates: list["_StreamState"] = dataclasses.field(default_factory=list)
    # Virtual channel this stream's beats travel in.  The engines
    # arbitrate one beat per (link, VC) per cycle, so streams in
    # different VCs never block each other on a shared physical link;
    # with num_vcs=1 every stream is VC 0 and arbitration degenerates to
    # the historical whole-link behavior bit-for-bit.
    vc: int = 0

    def __post_init__(self):
        if self.rate:
            self.rate = {e: _frac(r) for e, r in self.rate.items()}
        if self.inject:
            self.inject = {
                e: (_frac(s), _frac(r)) for e, (s, r) in self.inject.items()
            }
        # Lazy structures (built on first use, shared across runs).  The
        # *topology* (units, consumer graph, link sets, final counts) is a
        # pure function of prereqs/groups/finals and can be adopted from an
        # identically-structured stream (compile-once sweeps share it across
        # injection-rate points via StreamSpec); the *records* (_uinfo)
        # reference this instance's arrival lists and inject clock, so they
        # are always built per stream.
        self._units: Optional[list[tuple[Edge, ...]]] = None
        self._unit_consumers: Optional[list[tuple[int, ...]]] = None
        self._unit_links: Optional[list[tuple[Edge, ...]]] = None
        self._unit_final_count: Optional[list[int]] = None
        self._uinfo: Optional[list[tuple]] = None
        self._finals_set: frozenset[Edge] = frozenset(self.finals)
        # Heap-engine state (rebuilt per run by _heap_init).
        self._unit_ready: list[Optional[int]] = []
        self._uheap: list[tuple[int, int]] = []
        self._ready_list: list[int] = []
        self._ready_set: set[int] = set()
        self._final_need: int = 0
        self._gate_t0: Optional[int] = None
        # Provenance: the op this stream was lowered from, as set by the
        # spec builders — ("unicast", src, dst, nbytes) etc.  Mid-run
        # fault arrival (noc.resilience.timeline) re-lowers affected live
        # streams from it; checkpoints serialize it so restored runs can
        # still take later fault events.  None for hand-built streams
        # (such streams cannot be re-lowered and fail loudly if a fault
        # event hits them).
        self.origin: Optional[tuple] = None

    def edges(self) -> list[Edge]:
        out = set(self.prereqs)
        for g in self.groups:
            out.update(g)
        return list(out)

    def _crossed(self, e: Edge) -> int:
        return len(self.arrivals.get(e, ()))

    def _t0(self) -> Optional[int]:
        """Time origin of the inject schedule: 0 for ungated streams, the
        cycle after the last gate stream drains otherwise (``None`` while
        any gate is still in flight — the stream is not ready at any t)."""
        if not self.gates:
            return 0
        if self._gate_t0 is None:
            done = [g.done_cycle for g in self.gates]
            if any(d is None for d in done):
                return None
            self._gate_t0 = max(done) + 1  # drained at d -> injectable at d+1
        return self._gate_t0

    def _beat_ready(self, e: Edge, b: int, t: int) -> bool:
        if b >= self.n_beats:
            return False
        t0 = self._t0()
        if t0 is None or t < t0:
            return False
        for up in self.prereqs.get(e, ()):
            arr = self.arrivals.get(up, ())
            if len(arr) <= b or arr[b] >= t:
                return False
        if e in self.inject:
            start, rate = self.inject[e]
            if t < t0 + start + b * rate:
                return False
        r = self.rate.get(e, 1)
        arr = self.arrivals.get(e, ())
        if arr and arr[-1] > t - r:
            return False
        return True

    # -- unit structure ----------------------------------------------------
    #
    # A *unit* is the atomic request granularity: one fork group, or one
    # loose prereq-only edge.  Unit order == the order ``requests`` has
    # always returned groups in, so arbitration is unchanged.  Every edge
    # belongs to at most one unit (builders guarantee this); an edge that
    # appears only as someone's prereq and in no unit can never advance.

    def _build_topology(self) -> None:
        """Unit list, consumer graph, link sets and final counts — a pure
        function of prereqs/groups/finals, shareable across streams with
        identical structure (see :meth:`_adopt_topology`)."""
        units: list[tuple[Edge, ...]] = [tuple(g) for g in self.groups]
        seen = {e for g in self.groups for e in g}
        units.extend((e,) for e in self.prereqs if e not in seen)
        edge_unit: dict[Edge, int] = {}
        for i, u in enumerate(units):
            for e in u:
                edge_unit[e] = i
        consumers: list[set[int]] = [set() for _ in units]
        for i, u in enumerate(units):
            for e in u:
                for up in self.prereqs.get(e, ()):
                    j = edge_unit.get(up)
                    if j is not None and j != i:
                        consumers[j].add(i)
        self._units = units
        self._unit_consumers = [tuple(sorted(c)) for c in consumers]
        self._unit_links = [
            tuple(e for e in u if e[0] != e[1]) for u in units
        ]
        self._unit_final_count = [
            sum(1 for e in u if e in self._finals_set) for u in units
        ]

    def _topology(self) -> tuple:
        """The shareable unit topology (built on demand)."""
        if self._units is None:
            self._build_topology()
        return (self._units, self._unit_consumers, self._unit_links,
                self._unit_final_count)

    def _adopt_topology(self, topo: tuple) -> None:
        """Install a topology computed from an identically-structured stream
        (compile-once path); skips the consumer-graph rebuild entirely."""
        (self._units, self._unit_consumers, self._unit_links,
         self._unit_final_count) = topo

    def _ensure_units(self) -> None:
        if self._uinfo is not None:
            return
        if self._units is None:
            self._build_topology()
        units = self._units
        # Compiled per-unit readiness records for the incremental hot path:
        # direct references to the arrival lists (no Edge hashing) and
        # integer-only inject/rate ceilings.  ceil(s + b*r) over Fractions
        # s=sn/d, r=rn/d is -(-(sn + b*rn)//d); ceil(arr[-1] + r) for
        # integer arrivals is arr[-1] + ceil(r).  Arrival lists are created
        # eagerly (for prereq-only edges too) so every engine sees the same
        # ``arrivals`` dict shape and the records stay valid as they fill.
        uinfo = []
        for u in units:
            recs = []
            for e in u:
                arr = self.arrivals.setdefault(e, [])
                ups = tuple(
                    self.arrivals.setdefault(up, [])
                    for up in self.prereqs.get(e, ())
                )
                inj = None
                if e in self.inject:
                    s, r = self.inject[e]
                    d = s.denominator * r.denominator // math.gcd(
                        s.denominator, r.denominator
                    )
                    inj = (
                        s.numerator * (d // s.denominator),
                        r.numerator * (d // r.denominator),
                        d,
                    )
                recs.append((arr, ups, inj, math.ceil(self.rate.get(e, 1))))
            uinfo.append(tuple(recs))
        self._uinfo = uinfo
        self._final_arrs = [
            self.arrivals.setdefault(e, []) for e in self.finals
        ]

    def requests(self, t: int) -> list[list[Edge]]:
        """Fork-atomic edge groups that could advance one beat at cycle t."""
        self._ensure_units()
        reqs = []
        for u in self._units:
            b = len(self.arrivals.get(u[0], ()))
            if len(u) > 1 and any(
                len(self.arrivals.get(e, ())) != b for e in u
            ):
                continue
            if all(self._beat_ready(e, b, t) for e in u):
                reqs.append(list(u))
        return reqs

    def advance(self, group: Sequence[Edge], t: int) -> None:
        self.ready_hint = None
        for e in group:
            self.arrivals.setdefault(e, []).append(t)
        # Completion can only change when a final edge just advanced.
        if self.done_cycle is None and not self._finals_set.isdisjoint(group):
            if all(self._crossed(e) >= self.n_beats for e in self.finals):
                self.done_cycle = t

    def _ready_after(self, e: Edge, b: int) -> Optional[int]:
        """Earliest integer cycle at which ``_beat_ready(e, b, .)`` holds.

        ``None`` means "not until some other edge advances first" (beat
        exhausted, an upstream arrival for beat ``b`` still missing, or a
        gate stream still in flight) — such edges contribute no event to
        the idle fast-forward.  Thresholds are exact integer ceilings of
        Fraction arithmetic, so they agree with ``_beat_ready`` exactly.
        """
        if b >= self.n_beats:
            return None
        t0 = self._t0()
        if t0 is None:
            return None
        thr = t0
        for up in self.prereqs.get(e, ()):
            arr = self.arrivals.get(up, ())
            if len(arr) <= b:
                return None
            if arr[b] + 1 > thr:
                thr = arr[b] + 1
        if e in self.inject:
            start, rate = self.inject[e]
            thr = max(thr, math.ceil(t0 + start + b * rate))
        arr = self.arrivals.get(e, ())
        if arr:
            thr = max(thr, math.ceil(arr[-1] + self.rate.get(e, 1)))
        return thr

    def _unit_next(self, i: int) -> Optional[int]:
        """Earliest cycle unit ``i`` can fire its next beat (None=blocked).

        Integer-only mirror of :meth:`_ready_after` over the compiled unit
        records — the heap engine's innermost loop."""
        info = self._uinfo[i]
        b = len(info[0][0])
        if b >= self.n_beats:
            return None
        if len(info) > 1:
            for rec in info:
                if len(rec[0]) != b:
                    return None
        t0 = 0
        if self.gates:
            t0 = self._t0()
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

    def next_ready_cycle(self) -> Optional[int]:
        """Earliest cycle at which any request can fire, given current
        arrivals (callers invoke it on idle cycles, where it necessarily
        exceeds the current cycle).  Full recompute — the reference
        semantics mirrored incrementally by :meth:`next_ready`.
        """
        self._ensure_units()
        best: Optional[int] = None
        for i in range(len(self._units)):
            c = self._unit_next(i)
            if c is not None and (best is None or c < best):
                best = c
        return best

    # -- incremental readiness (heap-engine hot path) ----------------------

    def _heap_init(self) -> None:
        """(Re)build the per-unit ready cache for a fresh run.

        Topology (units/consumers) is computed once and reused; the cached
        ready cycles and the per-stream unit heap are rebuilt because
        arrivals may have accumulated in a previous run.
        """
        self._ensure_units()
        ur: list[Optional[int]] = []
        heap: list[tuple[int, int]] = []
        for i in range(len(self._units)):
            c = self._unit_next(i)
            ur.append(c)
            if c is not None:
                heap.append((c, i))
        heapq.heapify(heap)
        self._unit_ready = ur
        self._uheap = heap
        self._ready_list = []
        self._ready_set = set()
        # Remaining final-edge arrivals before this stream completes: the
        # done check in advance_unit is a counter decrement instead of a
        # length scan over every final arrival list per advanced beat.
        nb = self.n_beats
        self._final_need = sum(nb - len(a) for a in self._final_arrs)

    def ready_units(self, t: int) -> list[int]:
        """Unit indices ready at cycle ``t``, in unit (arbitration) order.

        Readiness for a fixed beat is monotone in t, so once a unit drains
        off the heap into the ready list it stays there until it advances.
        Stale heap entries (superseded by an earlier recomputed cycle) are
        dropped lazily on pop.
        """
        heap = self._uheap
        ur = self._unit_ready
        while heap and heap[0][0] <= t:
            c, i = heapq.heappop(heap)
            if ur[i] == c and i not in self._ready_set:
                bisect.insort(self._ready_list, i)
                self._ready_set.add(i)
        return self._ready_list

    def advance_unit(self, i: int, t: int) -> None:
        """Advance unit ``i`` at cycle ``t`` and re-derive readiness for it
        and its dirty set (downstream consumer units only).

        Equivalent to ``advance(self._units[i], t)`` but appends through
        the compiled arrival-list references (no Edge hashing)."""
        self.ready_hint = None
        for rec in self._uinfo[i]:
            rec[0].append(t)
        nf = self._unit_final_count[i]
        if nf and self.done_cycle is None:
            self._final_need -= nf
            if self._final_need == 0:
                self.done_cycle = t
        if i in self._ready_set:
            self._ready_set.remove(i)
            self._ready_list.remove(i)
        c = self._unit_next(i)
        self._unit_ready[i] = c
        if c is not None:
            heapq.heappush(self._uheap, (c, i))
        for j in self._unit_consumers[i]:
            # A consumer with a cached numeric cycle already had all
            # prereqs for its current beat; the new arrival belongs to a
            # later beat and cannot move it.  Only blocked consumers can
            # become ready.
            if self._unit_ready[j] is None:
                cj = self._unit_next(j)
                if cj is not None:
                    self._unit_ready[j] = cj
                    heapq.heappush(self._uheap, (cj, j))

    def next_ready(self) -> Optional[int]:
        """Incremental mirror of :meth:`next_ready_cycle`: min over the
        drained ready list and the (lazily validated) unit-heap top."""
        best: Optional[int] = None
        ur = self._unit_ready
        for i in self._ready_list:
            c = ur[i]
            if best is None or c < best:
                best = c
        heap = self._uheap
        while heap:
            c, i = heap[0]
            if ur[i] != c or i in self._ready_set:
                heapq.heappop(heap)
                continue
            if best is None or c < best:
                best = c
            break
        return best

    def gate_released(self) -> None:
        """A gate stream completed: re-derive readiness of blocked units.

        Called by the engines when the *last* gate drains (before that,
        units recompute to None anyway, so calling early is harmless)."""
        self.ready_hint = None
        if not self._unit_ready:
            return  # heap cache not built (cycle/event engine) — nothing cached
        for i, c in enumerate(self._unit_ready):
            if c is None:
                ci = self._unit_next(i)
                if ci is not None:
                    self._unit_ready[i] = ci
                    heapq.heappush(self._uheap, (ci, i))

    # -- diagnostics -------------------------------------------------------

    def stall_report(self) -> str:
        """One-line description of why this stream cannot advance: frontier
        beats of its final edges plus the first few blocking conditions."""
        self._ensure_units()
        front = ", ".join(
            f"{tuple(e[0])}->{tuple(e[1])}@{self._crossed(e)}/{self.n_beats}"
            for e in self.finals[:3]
        )
        if self.gates and self._t0() is None:
            pend = sum(1 for g in self.gates if g.done_cycle is None)
            return f"finals [{front}] gated on {pend} unfinished upstream stream(s)"
        reasons = []
        for i, u in enumerate(self._units):
            if self._unit_next(i) is not None:
                continue
            b = len(self.arrivals.get(u[0], ()))
            if b >= self.n_beats:
                continue
            if len(u) > 1 and any(
                len(self.arrivals.get(e, ())) != b for e in u
            ):
                reasons.append(f"fork group {[tuple(e[1]) for e in u]} desynchronized")
                continue
            for e in u:
                for up in self.prereqs.get(e, ()):
                    arr = self.arrivals.get(up, ())
                    if len(arr) <= b:
                        reasons.append(
                            f"edge {tuple(e[0])}->{tuple(e[1])} beat {b} awaits "
                            f"upstream {tuple(up[0])}->{tuple(up[1])} "
                            f"({len(arr)} arrived)"
                        )
                        break
                else:
                    continue
                break
            if len(reasons) >= 3:
                break
        why = "; ".join(reasons) if reasons else "no blocked edge found"
        return f"finals [{front}]: {why}"


def _chain(edges: list[Edge]) -> tuple[dict[Edge, list[Edge]], list[list[Edge]]]:
    prereqs = {edges[0]: []}
    for a, b in zip(edges, edges[1:]):
        prereqs[b] = [a]
    return prereqs, [[e] for e in edges]


# ---------------------------------------------------------------------------
# Start-independent stream structure (compile-once path).
#
# Everything ``add_unicast`` / ``add_multicast`` / ``add_reduction`` /
# ``add_timed`` derive from a workload op — routes, fork/join trees, the
# prereq/group graph, rates, finals, the VC — is independent of the
# injection clock.  A :class:`StreamSpec` captures exactly that, so a sweep
# can lower a workload once and instantiate fresh streams per injection
# rate by swapping only the inject ``start``.  ``add_*`` build through the
# same ``_*_structure`` helpers, so the compiled and direct paths cannot
# drift.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamSpec:
    """Compiled, start-independent form of one stream.

    ``instantiate`` builds a fresh :class:`_StreamState` whose inject clock
    is ``start + inject_offset`` at ``inject_rate`` cycles/beat on every
    edge of ``inject_edges``.  The unit topology (units, consumer graph,
    link sets, final counts) is computed on first instantiation and shared
    by every subsequent one — the cache key the compile-once sweeps rely
    on is simply the identity of the spec (one per (mesh, params, op)).
    Structure dicts are shared, never copied: streams only ever mutate
    their own ``arrivals``.
    """

    n_beats: int
    prereqs: dict
    groups: list
    rate: dict
    inject_edges: tuple
    inject_offset: float
    inject_rate: float
    finals: list
    vc: int = 0
    # Fault bookkeeping, resolved at spec-build time and *applied at
    # instantiation* — compiled workloads build specs on a scratch sim but
    # instantiate into the running one, so counters and CDG dependencies
    # must travel on the spec to land in the sim that actually runs.
    fault_meta: Optional[dict] = None          # EngineProfile counter deltas
    fault_deps: Optional[tuple] = None         # (vc, link-dependency tuple)
    # Provenance of the op this spec lowers — ("unicast", src, dst,
    # nbytes) and friends; carried onto the instantiated stream so
    # mid-run fault arrival can re-lower it (see _StreamState.origin).
    origin: Optional[tuple] = None
    _topology: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def instantiate(self, sim: "NoCSim", start: float) -> "_StreamState":
        st = _StreamState(
            n_beats=self.n_beats,
            prereqs=self.prereqs,
            groups=self.groups,
            rate=self.rate,
            # Native float addition, exactly like the historical add_*
            # builders (start + alpha rounds once as a double; __post_init__
            # then converts the result losslessly).
            inject={
                e: (start + self.inject_offset, self.inject_rate)
                for e in self.inject_edges
            },
            finals=self.finals,
            vc=self.vc,
        )
        st.origin = self.origin
        if self._topology is None:
            self._topology = st._topology()
        else:
            st._adopt_topology(self._topology)
        if self.fault_meta is not None:
            for k, v in self.fault_meta.items():
                sim._fault_counts[k] = sim._fault_counts.get(k, 0) + v
        if self.fault_deps is not None:
            vc, deps = self.fault_deps
            sim._fault_deps.setdefault(vc, set()).update(deps)
            sim._fault_deps_dirty = True
        sim.streams.append(st)
        return st


def _flaky_rates(faults, rate: dict, edges) -> int:
    """Fold the expected flaky-link retry penalty (exact Fraction, seeded
    jitter — see ``faults.model.FaultSet.flaky_penalty``) into the
    per-edge beat rates; returns the number of flaky link edges touched.
    Self/sink edges never traverse a physical link and pay nothing."""
    n = 0
    for e in edges:
        a, b = e
        if a == b or b.x < 0 or b.y < 0:
            continue
        pen = faults.flaky_penalty(a, b)
        if pen:
            rate[e] = _frac(rate.get(e, 1)) + pen
            n += 1
    return n


def _unicast_structure(mesh, policy, src: Coord, dst: Coord, pid: int,
                       faults=None):
    """Chain structure of a policy-routed unicast; returns (prereqs, groups,
    finals, inject_edge, path, detoured).  Under faults the route comes
    from ``faults.repair`` (base route when healthy, odd-even-legal
    detour otherwise)."""
    if faults is None:
        path = policy.route(mesh, src, dst, pid)
        detoured = False
    else:
        path, detoured = repair_route(mesh, faults, policy, src, dst, pid)
    edges: list[Edge] = [(src, src)] + list(zip(path, path[1:])) + [(dst, dst)]
    prereqs, groups = _chain(edges)
    return prereqs, groups, [edges[-1]], edges[0], path, detoured


def _multicast_structure(mesh, policy, src: Coord, maddr: MultiAddress,
                         faults=None):
    """Fork-tree structure of a multicast; returns (prereqs, groups, finals,
    inject_edge, regraft_info).  Fork groups advance in lockstep (Section
    3.1.2).  Under faults the tree is re-grafted around dead elements
    (dead destinations drop out of the tree and hence out of ``finals``)."""
    if faults is None:
        fork = fork_tree(mesh, src, maddr, policy=policy)
        info = None
    else:
        fork, info = fork_tree_degraded(
            mesh, src, maddr, policy=policy, faults=faults)
    # fork maps router -> set(next hops); local delivery encoded as self.
    children: dict[Coord, list[Coord]] = {
        k: sorted(v, key=tuple) for k, v in fork.items()
    }
    prereqs: dict[Edge, list[Edge]] = {}
    groups: list[list[Edge]] = []
    inject_edge: Edge = (src, src)
    prereqs[inject_edge] = []
    groups.append([inject_edge])
    parent_edge: dict[Coord, Edge] = {src: inject_edge}
    order = [src]
    seen = {src}
    while order:
        u = order.pop(0)
        outs = children.get(u, [])
        group = []
        for v in outs:
            e: Edge = (u, v) if v != u else (u, u)
            if e == parent_edge.get(u):
                continue
            prereqs[e] = [parent_edge[u]]
            group.append(e)
            if v != u and v not in seen:
                parent_edge[v] = e
                seen.add(v)
                order.append(v)
        if group:
            groups.append(group)
    dests = maddr.destinations(mesh)
    finals = [(d, d) for d in dests if (d, d) in prereqs]
    return prereqs, groups, finals or [inject_edge], inject_edge, info


def _reduction_structure(mesh, policy, sources: tuple[Coord, ...], dst: Coord,
                         faults=None):
    """Join-tree structure of a wide reduction; returns (prereqs, groups,
    rate, finals, inject_edges, regraft_info).  A router with ``f``
    selected inputs sustains one fully-reduced beat per ``f - 1`` cycles
    (Section 3.1.4).  Under faults the join tree is re-grafted (dead
    sources drop their contribution)."""
    if faults is None:
        join = join_tree(mesh, list(sources), dst, policy=policy)
        info = None
    else:
        join, info = join_tree_degraded(
            mesh, list(sources), dst, policy=policy, faults=faults)
    # join maps router -> set(inputs); input==router encodes local source.
    prereqs: dict[Edge, list[Edge]] = {}
    rate: dict[Edge, float] = {}
    inject_edges: list[Edge] = []
    groups: list[list[Edge]] = []

    def in_edges(u: Coord) -> list[Edge]:
        out = []
        for w in sorted(join.get(u, ()), key=tuple):
            out.append((w, w) if w == u else (w, u))
        return out

    # Build edges from the join structure directly: for every router v
    # with inputs I(v), each input edge (w,v) w!=v is the out-edge of w;
    # its prereqs are all of w's inputs and its rate is f-1 for f >= 2
    # (a single two-input wide reduction unit per router, Section 3.1.4).
    for v, inputs in join.items():
        for w in sorted(inputs, key=tuple):
            if w == v:
                e: Edge = (v, v)  # local contribution inject
                prereqs.setdefault(e, [])
                inject_edges.append(e)
                groups.append([e])
            else:
                e = (w, v)
                ups = in_edges(w)
                prereqs[e] = ups
                f = len(ups)
                if f >= 2:
                    rate[e] = float(f - 1)
                groups.append([e])
    eject: Edge = (dst, dst)
    if eject not in prereqs:  # dst without local contribution
        prereqs[eject] = in_edges(dst)
        groups.append([eject])
        f = len(prereqs[eject])
        if f >= 2:
            rate[eject] = float(f - 1)
    else:
        # dst contributes locally: add a separate sink edge combining all.
        sink: Edge = (dst, Coord(-1, -1))
        prereqs[sink] = in_edges(dst)
        f = len(prereqs[sink])
        if f >= 2:
            rate[sink] = float(f - 1)
        groups.append([sink])
        eject = sink
    return prereqs, groups, rate, [eject], tuple(inject_edges), info


class NoCSim:
    """Cycle-stepped simulator over a shared link fabric."""

    def __init__(self, mesh: Mesh2D, params: NoCParams | None = None):
        self.mesh = mesh
        self.p = params or NoCParams()
        self.policy = get_policy(self.p.routing)
        # Fault injection: NoCParams.faults (None or an empty FaultSet,
        # which params normalizes to None, keeps this sim bit-identical
        # to the historical fault-free behavior).  Faults resolve during
        # stream construction — detours, tree re-grafts, flaky rate
        # penalties — so every engine honors them identically.
        self.faults = self.p.faults
        self._fault_counts: dict[str, int] = {
            "retries_paid": 0, "detoured_routes": 0, "regrafted_trees": 0,
        }
        self._fault_deps: dict[int, set] = {}   # vc -> link dependencies
        self._fault_deps_dirty = False
        self._escape_vc: Optional[int] = None
        if self.faults is not None:
            self.faults.validate_for(mesh)
            self._escape_vc = _escape_vc_of(self.p.routing, mesh,
                                            self.p.num_vcs)
        self.streams: list[_StreamState] = []
        self._atomic_busy_until = 0  # shared RMW unit for the SW barrier
        self._rr = 0  # round-robin arbitration counter, one slot per cycle
        self._pkt_seq = 0  # per-sim packet id: O1TURN split, packet-mode VCs
        self.recorders: list = []  # traffic.trace.TraceRecorder et al.
        self.last_profile = None  # EngineProfile of the last run(profile=True)
        self.telemetry = None  # telemetry.Collector when observability is on

    # -- arbitration counter -------------------------------------------------

    def _rr_next(self) -> int:
        v = self._rr
        self._rr += 1
        return v

    def _rr_skip(self, n: int) -> None:
        self._rr += n

    # -- trace hooks ---------------------------------------------------------

    def _record(self, kind: str, **kw) -> None:
        for r in self.recorders:
            r.record(kind, **kw)

    # -- stream builders ---------------------------------------------------

    def add_unicast(self, src: Coord, dst: Coord, nbytes: int, start: float = 0.0):
        self._record("unicast", src=src, dst=dst, nbytes=nbytes, start=start)
        spec = self.unicast_spec(src, dst, nbytes)
        return spec.instantiate(self, start)

    def unicast_spec(self, src: Coord, dst: Coord, nbytes: int) -> StreamSpec:
        """Compile a unicast without instantiating it (consumes a packet id
        — the o1turn route split and packet-mode VC slicing key on it, so
        compiled and direct lowering of the same op sequence agree)."""
        pid = self._pkt_seq
        self._pkt_seq += 1
        prereqs, groups, finals, inject_edge, path, detoured = (
            _unicast_structure(
                self.mesh, self.policy, src, dst, pid, self.faults
            )
        )
        n_beats = self.p.beats(nbytes)
        rate: dict = {}
        vc = self.p.vc_of("unicast", packet_id=pid)
        meta = deps = None
        if self.faults is not None:
            n_flaky = _flaky_rates(self.faults, rate, prereqs)
            if detoured and self._escape_vc is not None:
                vc = self._escape_vc  # escape VC: odd-even-legal routes only
            meta = {"retries_paid": n_beats * n_flaky,
                    "detoured_routes": int(detoured)}
            deps = (vc, tuple(route_turns(path)))
        return StreamSpec(
            n_beats=n_beats,
            prereqs=prereqs,
            groups=groups,
            rate=rate,
            inject_edges=(inject_edge,),
            # len(path)-1 == the Manhattan hop count for every healthy
            # (minimal) route; detours pay their true hop count.
            inject_offset=self.p.alpha(len(path) - 1),
            inject_rate=self.p.beta,
            finals=finals,
            vc=vc,
            fault_meta=meta,
            fault_deps=deps,
            origin=("unicast", src, dst, nbytes),
        )

    def add_multicast(self, src: Coord, maddr: MultiAddress, nbytes: int, start: float = 0.0):
        self._record("multicast", src=src, maddr=maddr, nbytes=nbytes, start=start)
        spec = self.multicast_spec(src, maddr, nbytes)
        return spec.instantiate(self, start)

    def multicast_spec(self, src: Coord, maddr: MultiAddress, nbytes: int) -> StreamSpec:
        prereqs, groups, finals, inject_edge, info = _multicast_structure(
            self.mesh, self.policy, src, maddr, self.faults
        )
        n_beats = self.p.beats(nbytes)
        rate: dict = {}
        meta = None
        if self.faults is not None:
            n_flaky = _flaky_rates(self.faults, rate, prereqs)
            meta = {"retries_paid": n_beats * n_flaky,
                    "regrafted_trees": int(info.changed)}
        return StreamSpec(
            n_beats=n_beats,
            prereqs=prereqs,
            groups=groups,
            rate=rate,
            inject_edges=(inject_edge,),
            inject_offset=self.p.alpha(1),
            inject_rate=self.p.beta,
            finals=finals,
            vc=self.p.vc_of("multicast"),
            fault_meta=meta,
            origin=("multicast", src, maddr, nbytes),
        )

    def add_reduction(
        self,
        sources: Sequence[Coord],
        dst: Coord,
        nbytes: int,
        start: float = 0.0,
        inject_alpha: float | None = None,
        traffic_class: str = "reduction",
    ):
        self._record(
            "reduction", sources=tuple(sources), dst=dst, nbytes=nbytes, start=start
        )
        spec = self.reduction_spec(
            sources, dst, nbytes, inject_alpha=inject_alpha,
            traffic_class=traffic_class,
        )
        return spec.instantiate(self, start)

    def reduction_spec(
        self,
        sources: Sequence[Coord],
        dst: Coord,
        nbytes: int,
        inject_alpha: float | None = None,
        traffic_class: str = "reduction",
    ) -> StreamSpec:
        prereqs, groups, rate, finals, inject_edges, info = (
            _reduction_structure(
                self.mesh, self.policy, tuple(sources), dst, self.faults
            )
        )
        n_beats = self.p.beats(nbytes)
        meta = None
        if self.faults is not None:
            n_flaky = _flaky_rates(self.faults, rate, prereqs)
            meta = {"retries_paid": n_beats * n_flaky,
                    "regrafted_trees": int(info.changed)}
        return StreamSpec(
            n_beats=n_beats,
            prereqs=prereqs,
            groups=groups,
            rate=rate,
            inject_edges=inject_edges,
            inject_offset=self.p.alpha(1) if inject_alpha is None else inject_alpha,
            inject_rate=self.p.beta,
            finals=finals,
            vc=self.p.vc_of(traffic_class),
            fault_meta=meta,
            origin=("reduction", tuple(sources), dst, nbytes, inject_alpha,
                    traffic_class),
        )

    def add_timed(self, at: Coord, cycles: float, start: float = 0.0):
        """A link-free timed interval at tile ``at`` (compute / barrier).

        The stream has a single self-edge beat whose inject threshold is
        ``start + cycles``, so it completes at ``ceil(t0 + start +
        cycles)`` where ``t0`` is its gate release (0 when ungated).
        Self-edges never enter link arbitration, so timed streams model
        tile-local occupancy — the lowering of ``ComputeOp`` /
        ``BarrierOp`` program nodes — without touching the fabric.  Not
        recorded by trace recorders (programs serialize as schema v3,
        which keeps the op form).
        """
        return self.timed_spec(at, cycles).instantiate(self, start)

    def timed_spec(self, at: Coord, cycles: float) -> StreamSpec:
        e: Edge = (at, at)
        return StreamSpec(
            n_beats=1,
            prereqs={e: []},
            groups=[[e]],
            rate={},
            inject_edges=(e,),
            inject_offset=cycles,
            inject_rate=0,
            finals=[e],
            origin=("timed", at, cycles),
        )

    # -- engine -------------------------------------------------------------

    def run(self, max_cycles: int = 2_000_000, engine: str = "heap",
            profile: bool = False, stop_at: Optional[int] = None,
            start_cycle: int = 0, telemetry=None):
        """Advance until all streams complete; returns the last done cycle
        (or an :class:`~repro_torch.core.noc.engine.EngineProfile` carrying the
        makespan plus engine counters when ``profile=True``).

        ``engine='heap'`` (default) schedules pending streams in a global
        min-heap keyed on exact next-ready cycle with incremental per-unit
        readiness — the fast path for large meshes.  ``engine='shard'``
        (or ``'shard:GXxGY:W'`` — region grid and worker count) partitions
        the mesh into rectangular regions and runs each region's
        per-(link, VC) arbitration independently inside conservatively
        bounded epochs, reconciling boundary links at epoch edges; see
        ``noc.shard``.  ``engine='event'`` fast-forwards idle gaps but
        still scans every pending stream per active cycle;
        ``engine='cycle'`` is the legacy one-iteration-per-cycle loop.
        All engines are bit-identical (same per-stream arrivals,
        completion cycles and arbitration counter).

        ``stop_at`` pauses the run at an exact cycle boundary: only
        cycles in ``[start_cycle, stop_at)`` are simulated and the call
        returns ``stop_at`` when streams remain in flight.  A paused sim
        resumed with ``run(start_cycle=stop_at, ...)`` — directly, or
        after a checkpoint round trip through
        ``noc.resilience.checkpoint`` — is bit-identical to an
        uninterrupted run on every engine (same arrivals, done cycles and
        arbitration counter; see the pause/resume contract in
        ``noc.engine``).

        ``telemetry`` attaches a :class:`~repro_torch.core.noc.telemetry.Collector`
        for this and subsequent runs (it sticks on ``self.telemetry``, so a
        paused/restored sim keeps collecting without re-passing it).
        Telemetry observes beat advances but never feeds back into
        scheduling — the default ``telemetry=None`` path is untouched.
        """
        from repro_torch.core.noc.engine import EngineProfile

        if stop_at is not None and stop_at < start_cycle:
            raise ValueError(
                f"stop_at={stop_at} precedes start_cycle={start_cycle}")

        if telemetry is not None:
            self.telemetry = telemetry
        if self.telemetry is not None:
            self.telemetry.begin(self)

        # Exact deadlock gate for degraded runs: the unicast routes this
        # workload actually uses (base + detours) must have an acyclic
        # channel dependency graph per VC.  The escape-VC placement makes
        # this pass structurally when num_vcs affords it; otherwise this
        # raises RepairDeadlockError naming the VC count that would.
        if self.faults is not None and self._fault_deps_dirty:
            self._fault_deps_dirty = False
            verify_route_deps(self._fault_deps, self.p.routing, self.mesh,
                              self.p.num_vcs)

        prof = EngineProfile(engine=engine) if profile else None
        if engine == "heap":
            makespan = run_heap(self, max_cycles, prof,
                                stop_at=stop_at, start=start_cycle)
        elif engine == "event":
            makespan = run_event_driven(self, max_cycles,
                                        stop_at=stop_at, start=start_cycle)
        elif isinstance(engine, str) and engine.startswith("shard"):
            from repro_torch.core.noc.shard import parse_shard_engine, run_shard

            cfg = parse_shard_engine(engine)
            makespan = run_shard(self, max_cycles, cfg, prof,
                                 stop_at=stop_at, start=start_cycle)
        elif engine == "cycle":
            makespan = self._run_cycle(max_cycles, stop_at=stop_at,
                                       start=start_cycle)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        if prof is not None:
            prof.makespan = makespan
            fc = self._fault_counts
            prof.retries_paid = fc["retries_paid"]
            prof.detoured_routes = fc["detoured_routes"]
            prof.regrafted_trees = fc["regrafted_trees"]
            prof.fault_events = fc.get("fault_events", 0)
            prof.relowered_streams = fc.get("relowered_streams", 0)
            prof.dropped_streams = fc.get("dropped_streams", 0)
            self.last_profile = prof
            return prof
        return makespan

    def _run_cycle(self, max_cycles: int, stop_at: Optional[int] = None,
                   start: int = 0) -> int:
        """The legacy one-iteration-per-cycle reference loop."""
        from repro_torch.core.noc.engine import gate_dependents, stuck_error

        dependents = gate_dependents(self.streams)
        tel = self.telemetry
        t = start
        limit = max_cycles if stop_at is None else min(max_cycles, stop_at)
        while t < limit:
            pending = [s for s in self.streams if s.done_cycle is None]
            if not pending:
                break
            busy: set[tuple[Edge, int]] = set()  # (physical link, VC)
            progressed = False
            start = self._rr_next() % len(pending)
            for s in pending[start:] + pending[:start]:
                vc = s.vc
                for group in s.requests(t):
                    links = [e for e in group if e[0] != e[1]]
                    if any((e, vc) in busy for e in links):
                        continue
                    busy.update((e, vc) for e in links)
                    s.advance(group, t)
                    progressed = True
                    if tel is not None:
                        tel.count_group(s, group)
                if s.done_cycle is not None:
                    for dep in dependents.get(id(s), ()):
                        dep.gate_released()
            if not progressed and all(
                s.next_ready_cycle() is None for s in pending
            ):
                raise stuck_error(self, "deadlock", t, pending)
            t += 1
        unfinished = [s for s in self.streams if s.done_cycle is None]
        if unfinished:
            if stop_at is not None and stop_at <= max_cycles:
                return stop_at  # paused at the window boundary, not stuck
            raise stuck_error(self, "deadlock/timeout", t, unfinished)
        if not self.streams:
            return 0
        return max(s.done_cycle for s in self.streams)

    # -- barriers ------------------------------------------------------------

    def barrier_sw(self, participants: Sequence[Coord], counter: Coord) -> int:
        """Atomic-counter barrier: serialized 3-cycle RMW at the counter tile,
        then a multicast interrupt (the paper's SW baseline uses the HW
        multicast for notification)."""
        self._record("barrier_sw", participants=tuple(participants), counter=counter)
        self.streams.clear()
        arrive = 0
        last_done = 0
        busy_until = 0.0
        for c in participants:
            lat = self.p.alpha(self.mesh.hops(c, counter)) / 2.0  # one-way req
            t_arr = arrive + lat
            t_start = max(t_arr, busy_until)
            busy_until = t_start + 3.0  # read-modify-write, 3 cycles (§4.2.1)
            last_done = max(last_done, busy_until)
        # notify via multicast interrupt: one beat back to all participants
        diam = max(self.mesh.hops(counter, c) for c in participants)
        return int(last_done + self.p.hop_cycles * diam + 1)

    def barrier_hw(self, participants: Sequence[Coord], counter: Coord) -> int:
        """LsbAnd in-network reduction + multicast completion notification."""
        self._record("barrier_hw", participants=tuple(participants), counter=counter)
        self.streams.clear()
        # Barrier contributions are single LSU stores, not DMA bursts: no
        # DMA-descriptor round-trip, just the request path latency.  The
        # internal reduction is the barrier's own mechanism, not workload
        # traffic, so it is not re-recorded as a separate trace event.
        recorders, self.recorders = self.recorders, []
        try:
            self.add_reduction(
                list(participants), counter, nbytes=8, start=0.0, inject_alpha=2.0,
                traffic_class="barrier",
            )
        finally:
            self.recorders = recorders
        t_red = self.run()
        diam = max(self.mesh.hops(counter, c) for c in participants)
        return int(t_red + self.p.hop_cycles * diam + 1)
