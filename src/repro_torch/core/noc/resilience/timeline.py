"""Mid-run fault arrival: a seedable timeline of ``(cycle, FaultSet)``
events applied at checkpoint boundaries.

The fault subsystem resolves faults at *stream construction* time —
detoured routes, re-grafted trees, flaky rate penalties — which models a
fabric that is broken before the workload starts.  This module models
faults that arrive *during* the run without touching any engine's inner
loop:

    run to the event cycle (``stop_at`` pause) -> optionally checkpoint
    -> compose the event's faults into the active set -> re-lower the
    surviving affected traffic through the same detour/re-graft/escape-VC
    machinery -> resume (``start_cycle``).

Because the pause is an exact cycle boundary and re-lowering reuses the
static fault path, the per-VC CDG deadlock gate re-runs on the composed
fault set before the resumed segment simulates (``NoCSim.run`` re-checks
whenever new route dependencies were added), and an **empty timeline is
bit-identical to a plain ``sim.run()``** — the segment loop never
executes and nothing is touched.

Re-lowering semantics (deterministic by construction):

* Only *live* streams whose route touches a newly-dead or newly-flaky
  link — or whose required endpoints died — are affected; everything
  else keeps its arrival lists and frontier untouched.
* An affected stream is re-lowered from its provenance
  (``_StreamState.origin``) for its **remaining** traffic: delivered
  beats = the minimum final-edge arrival count, remainder re-lowered as
  ``remaining * beat_bytes`` bytes through the composed fault set.  The
  new stream replaces the old **in place** (same stream index), so
  round-robin arbitration positions are preserved for every other
  stream.  Its injection re-arms at the event cycle (fresh DMA setup
  ``alpha``); a stream still waiting on unreleased gates keeps its gates
  and re-arms relative to their release, like a fresh lowering would.
* Drop rules mirror ``faults.model.degrade_program``: a unicast with a
  dead endpoint, a multicast with a dead source or all destinations
  dead, a reduction with a dead root or all sources dead, and a timed
  stream on a dead tile are *tombstoned* — ``done_cycle`` set to the
  event cycle, so gated successors release the cycle after (partial
  delivery stands; the op is abandoned, not retried).
* Hand-built streams (``origin is None``) cannot be re-lowered; a fault
  event that touches one raises.

``EngineProfile`` reports ``fault_events`` / ``relowered_streams`` /
``dropped_streams`` for runs driven through :func:`run_with_timeline`.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional, Sequence

from repro_torch.core.noc.faults.model import FaultSet
from repro_torch.core.noc.faults.repair import escape_vc as _escape_vc_of
from repro_torch.core.topology import Mesh2D


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """``faults`` arrive (are added to the active set) at ``cycle``."""

    cycle: int
    faults: FaultSet

    def __post_init__(self):
        if self.cycle < 0:
            raise ValueError(f"fault event cycle must be >= 0, got {self.cycle}")

    def to_dict(self) -> dict:
        return {"cycle": self.cycle, "faults": self.faults.to_dict()}

    @staticmethod
    def from_dict(d: dict) -> "FaultEvent":
        return FaultEvent(int(d["cycle"]), FaultSet.from_dict(d["faults"]))


class FaultTimeline:
    """Normalized sequence of fault events: sorted by cycle, same-cycle
    events merged by :meth:`FaultSet.union`, empty fault sets dropped."""

    __slots__ = ("events",)

    def __init__(self, events: Sequence[FaultEvent] = ()):
        merged: dict[int, FaultSet] = {}
        for ev in events:
            if ev.faults.empty:
                continue
            cur = merged.get(ev.cycle)
            merged[ev.cycle] = (
                ev.faults if cur is None else cur.union(ev.faults))
        self.events: tuple[FaultEvent, ...] = tuple(
            FaultEvent(c, fs) for c, fs in sorted(merged.items()))

    @property
    def empty(self) -> bool:
        return not self.events

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultTimeline)
                and self.events == other.events)

    def __repr__(self) -> str:
        return f"FaultTimeline({list(self.events)!r})"

    def to_dict(self) -> dict:
        return {"events": [ev.to_dict() for ev in self.events]}

    @staticmethod
    def from_dict(d: dict) -> "FaultTimeline":
        return FaultTimeline(
            [FaultEvent.from_dict(e) for e in d.get("events", ())])

    @staticmethod
    def sample(
        mesh: Mesh2D,
        events: int = 1,
        seed: int = 0,
        cycle_window: tuple[int, int] = (50, 500),
        dead_links: int = 1,
        dead_routers: int = 0,
        flaky_links: int = 0,
        keep_connected: bool = True,
    ) -> "FaultTimeline":
        """Seeded random timeline: ``events`` fault arrivals at cycles
        drawn from ``cycle_window``, each a ``FaultSet.sample`` with the
        requested element counts (connectivity-preserving by default)."""
        rng = random.Random(seed)
        out = []
        for _ in range(events):
            cycle = rng.randrange(cycle_window[0], max(cycle_window[1],
                                                       cycle_window[0] + 1))
            fs = FaultSet.sample(
                mesh, dead_links=dead_links, dead_routers=dead_routers,
                flaky_links=flaky_links, seed=rng.randrange(1 << 31),
                keep_connected=keep_connected,
            )
            out.append(FaultEvent(cycle, fs))
        return FaultTimeline(out)


# -- event application -------------------------------------------------------


def _link_edges(st) -> list:
    """Physical link edges of a stream (self-edges model local
    inject/eject and never traverse the fabric)."""
    return [e for e in st.edges() if e[0] != e[1]]


def _affected(st, old: Optional[FaultSet], new: FaultSet) -> bool:
    """True when ``new`` changes the fault status of any link this stream
    crosses relative to ``old`` (newly dead, or newly/differently flaky)."""
    for a, b in _link_edges(st):
        if new.link_is_dead(a, b):
            if old is None or not old.link_is_dead(a, b):
                return True
            continue
        nf = new.flaky_of(a, b)
        of = old.flaky_of(a, b) if old is not None else None
        if nf != of:
            return True
    return False


def _drop_verdict(origin: tuple, faults: FaultSet, mesh: Mesh2D) -> bool:
    """Mirror of ``degrade_program``'s drop rules, keyed on provenance."""
    kind = origin[0]
    dead = faults.router_is_dead
    if kind == "unicast":
        _, src, dst, _n = origin
        return dead(src) or dead(dst)
    if kind == "multicast":
        _, src, maddr, _n = origin
        if dead(src):
            return True
        return all(dead(d) for d in maddr.destinations(mesh))
    if kind == "reduction":
        _, sources, dst, _n, _ia, _tc = origin
        if dead(dst):
            return True
        return all(dead(s) for s in sources)
    if kind == "timed":
        _, at, _cycles = origin
        return dead(at)
    raise ValueError(f"unknown stream origin kind {kind!r}")


def _relower(sim, idx: int, st, tf: int) -> None:
    """Replace live stream ``idx`` in place with its remaining traffic
    lowered through the (already composed) ``sim.faults``."""
    origin = st.origin
    kind = origin[0]
    delivered = min(
        (len(st.arrivals.get(e, ())) for e in st.finals), default=0)
    remaining = st.n_beats - delivered
    if remaining <= 0:  # pragma: no cover - a drained stream is done
        return
    nbytes = remaining * sim.p.beat_bytes
    if kind == "unicast":
        _, src, dst, _n = origin
        spec = sim.unicast_spec(src, dst, nbytes)
    elif kind == "multicast":
        _, src, maddr, _n = origin
        spec = sim.multicast_spec(src, maddr, nbytes)
    elif kind == "reduction":
        _, sources, dst, _n, inject_alpha, traffic_class = origin
        spec = sim.reduction_spec(
            sources, dst, nbytes,
            inject_alpha=inject_alpha, traffic_class=traffic_class)
    else:  # timed streams never cross links; they are dropped or kept
        raise ValueError(f"cannot re-lower stream of kind {kind!r}")
    # Gated-and-unreleased streams have delivered nothing; re-arm relative
    # to the eventual gate release (start=0), exactly like a fresh
    # lowering.  Everything else re-arms its DMA at the event cycle.
    pending_gates = bool(st.gates) and st._t0() is None
    new = spec.instantiate(sim, 0.0 if pending_gates else float(tf))
    sim.streams.pop()  # instantiate appended it; it replaces idx instead
    new.gates = list(st.gates)
    sim.streams[idx] = new


def apply_fault_event(sim, ev: FaultEvent) -> dict:
    """Fold one fault arrival into a sim paused at ``ev.cycle``: compose
    the fault sets, install the composed set (escape VC included),
    tombstone doomed streams and re-lower the affected survivors.

    Returns ``{"relowered": n, "dropped": n}``.  The sim counters the
    next ``run(profile=True)`` reports are updated too, and any new route
    dependencies mark the CDG dirty so the resumed run re-verifies
    deadlock freedom on the composed fault set before simulating.
    """
    old = sim.faults
    composed = old.union(ev.faults) if old is not None else ev.faults
    composed.validate_for(sim.mesh)
    tf = ev.cycle
    sim.p = dataclasses.replace(sim.p, faults=composed)
    sim.faults = sim.p.faults
    if sim.faults is not None:
        sim._escape_vc = _escape_vc_of(
            sim.p.routing, sim.mesh, sim.p.num_vcs)
    fc = sim._fault_counts
    fc["fault_events"] = fc.get("fault_events", 0) + 1
    replaced: dict[int, object] = {}
    n_drop = n_relower = 0
    for idx, st in enumerate(sim.streams):
        if st.done_cycle is not None:
            continue
        if st.origin is None:
            if _affected(st, old, composed):
                raise RuntimeError(
                    f"fault event at cycle {tf} hits hand-built stream "
                    f"#{idx} (no lowering provenance); only builder-made "
                    "streams can be re-lowered mid-run")
            continue
        if _drop_verdict(st.origin, composed, sim.mesh):
            st.done_cycle = tf
            st.ready_hint = None
            n_drop += 1
            continue
        if st.origin[0] == "timed" or not _affected(st, old, composed):
            continue
        _relower(sim, idx, st, tf)
        replaced[id(st)] = sim.streams[idx]
        n_relower += 1
    fc["dropped_streams"] = fc.get("dropped_streams", 0) + n_drop
    fc["relowered_streams"] = fc.get("relowered_streams", 0) + n_relower
    # Rewire gate references onto the replacement streams and drop the
    # cached gate origins / readiness hints of every live stream — a gate
    # may have been tombstoned or replaced outside any engine's view.
    for st in sim.streams:
        if st.done_cycle is not None:
            continue
        if any(id(g) in replaced for g in st.gates):
            st.gates = [replaced.get(id(g), g) for g in st.gates]
        st._gate_t0 = None
        st.ready_hint = None
    tel = getattr(sim, "telemetry", None)
    if tel is not None:
        tel.annotate(
            tf, "fault_event",
            f"{ev.faults.describe()}; relowered={n_relower}, "
            f"dropped={n_drop}")
    return {"relowered": n_relower, "dropped": n_drop}


def run_with_timeline(
    sim,
    timeline: Optional[FaultTimeline],
    max_cycles: int = 2_000_000,
    engine: str = "heap",
    profile: bool = False,
    checkpoint_events: bool = False,
):
    """Run ``sim`` to completion, applying ``timeline``'s fault events at
    their cycles.  An empty (or None) timeline is exactly ``sim.run()`` —
    bit-identical, no segmenting.

    The return convention matches ``sim.run``: the makespan, or the
    ``EngineProfile`` when ``profile=True`` (per-segment profiles folded
    into one via ``EngineProfile.absorb`` and left on
    ``sim.last_profile``).  With ``checkpoint_events`` every event
    boundary is also snapshotted (``resilience.checkpoint``) and the
    call returns ``(result, [Snapshot, ...])``.
    """
    if timeline is None or timeline.empty:
        out = sim.run(max_cycles=max_cycles, engine=engine, profile=profile)
        return (out, []) if checkpoint_events else out
    from repro_torch.core.noc.resilience.checkpoint import checkpoint

    total = None
    snaps = []
    t = 0
    r = 0

    def _segment(**kw):
        nonlocal total, r
        out = sim.run(max_cycles=max_cycles, engine=engine,
                      profile=profile, **kw)
        if profile:
            total = out if total is None else (total.absorb(out) or total)
            r = out.makespan
        else:
            r = out
        return r

    for ev in timeline:
        if all(st.done_cycle is not None for st in sim.streams):
            break
        _segment(stop_at=ev.cycle, start_cycle=t)
        t = ev.cycle
        if r == ev.cycle and any(st.done_cycle is None
                                 for st in sim.streams):
            if checkpoint_events:
                snaps.append(checkpoint(sim, ev.cycle))
            apply_fault_event(sim, ev)
    if any(st.done_cycle is None for st in sim.streams):
        _segment(start_cycle=t)
    if profile:
        sim.last_profile = total
        return (total, snaps) if checkpoint_events else total
    return (r, snaps) if checkpoint_events else r
