"""Collective Program IR: declarative op nodes with explicit dependencies.

A :class:`Program` is the single declarative description of a fabric
workload — the representation every emitter (``schedules``, ``summa``,
``overlap``, the ``patterns`` storms) now produces and every execution
mode consumes (see :mod:`repro_torch.core.noc.program.lower`).  It replaces
the three historical surfaces (imperative ``NoCSim.add_*`` call
sequences, ad-hoc ``*_noc_events`` emitters, and flat phase-list
``Trace`` objects) with one DAG of typed ops:

``UnicastOp`` / ``MulticastOp`` / ``ReductionOp``
    fabric traffic, carrying the same payload fields as the
    corresponding :class:`~repro_torch.core.noc.traffic.trace.TrafficEvent`;
``ComputeOp``
    a per-tile compute interval (cycles derived from ``model.py``-style
    cost terms), occupying no links — the node that lets a program
    express comm/compute overlap (double-buffered SUMMA);
``BarrierOp``
    an analytic barrier interval (SW atomic counter or HW LsbAnd,
    ``NoCParams.barrier_sw/hw``) over a participant set.

Every op has an ``id`` (its index in ``Program.ops``), explicit
``deps`` (ids of ops that must complete before it may start), a
``start`` offset (cycles after its release), and a ``phase`` stamp.
``deps`` always reference *earlier* ids, so programs are DAGs by
construction.  ``phase`` is legacy-interop metadata: it drives the
barrier/window execution modes and the lossless ``Trace`` round trip;
the per-op execution mode (``mode='op'``) ignores it entirely.

Serialization is **trace schema v3**: :meth:`Program.to_json` writes
``{"version": 3, ..., "ops": [...]}``, and :meth:`Program.from_json`
additionally accepts v1/v2 trace files, converting their phase
structure into barrier dependencies (:func:`from_trace`) so legacy
captures keep replaying bit-identically through the new path.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, ClassVar, Optional

from repro_torch.core.noc.traffic.trace import Trace, TrafficEvent
from repro_torch.core.topology import Coord, Mesh2D, MultiAddress

PROGRAM_VERSION = 3

XY = tuple[int, int]


def _xy(c) -> XY:
    """Normalize a Coord / tuple / list to a plain ``(x, y)`` tuple."""
    t = tuple(c)
    if len(t) != 2:
        raise ValueError(f"expected an (x, y) coordinate, got {c!r}")
    return (int(t[0]), int(t[1]))


@dataclasses.dataclass(frozen=True, kw_only=True)
class Op:
    """Common op head: identity, dependencies, release offset, phase."""

    kind: ClassVar[str] = "?"

    id: int
    deps: tuple[int, ...] = ()
    start: float = 0.0
    phase: int = 0

    def nodes(self, mesh: Mesh2D) -> frozenset[XY]:
        """Endpoint tiles the op touches (window-mode 'tiles' footprint)."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["deps"] = list(self.deps)
        d["op"] = self.kind
        return d


@dataclasses.dataclass(frozen=True, kw_only=True)
class UnicastOp(Op):
    kind: ClassVar[str] = "unicast"

    src: XY
    dst: XY
    nbytes: int

    def nodes(self, mesh: Mesh2D) -> frozenset[XY]:
        return frozenset((self.src, self.dst))


@dataclasses.dataclass(frozen=True, kw_only=True)
class MulticastOp(Op):
    kind: ClassVar[str] = "multicast"

    src: XY
    dst: XY                      # (dst, mask) multi-address base
    x_mask: int = 0
    y_mask: int = 0
    nbytes: int = 0

    @property
    def maddr(self) -> MultiAddress:
        return MultiAddress(Coord(*self.dst), self.x_mask, self.y_mask)

    def nodes(self, mesh: Mesh2D) -> frozenset[XY]:
        out = {self.src}
        out.update(tuple(c) for c in self.maddr.destinations(mesh))
        return frozenset(out)


@dataclasses.dataclass(frozen=True, kw_only=True)
class ReductionOp(Op):
    kind: ClassVar[str] = "reduction"

    sources: tuple[XY, ...]
    dst: XY
    nbytes: int

    def nodes(self, mesh: Mesh2D) -> frozenset[XY]:
        return frozenset(self.sources) | {self.dst}


@dataclasses.dataclass(frozen=True, kw_only=True)
class BarrierOp(Op):
    """Analytic barrier interval over ``participants``.

    ``flavor`` selects the cost model: ``"sw"`` is the serialized
    atomic-counter baseline, anything else (``"hw"`` or the legacy
    empty string) the in-network LsbAnd barrier — mirroring how
    barrier trace events have always replayed.
    """

    kind: ClassVar[str] = "barrier"

    participants: tuple[XY, ...]
    counter: XY = (0, 0)
    flavor: str = ""

    def nodes(self, mesh: Mesh2D) -> frozenset[XY]:
        return frozenset(self.participants) | {self.counter}

    def cost(self, params) -> float:
        fn = params.barrier_sw if self.flavor == "sw" else params.barrier_hw
        return fn(len(self.participants))


@dataclasses.dataclass(frozen=True, kw_only=True)
class ComputeOp(Op):
    """A compute interval of ``cycles`` on ``tile`` — no fabric traffic.

    ``cycles`` typically comes from the ``model.py`` GEMM cost term
    (``tile^3 / (gemm_utilization * macs_per_cycle)``); see
    ``ProgramBuilder.compute(flops=...)`` and ``summa.summa_program``.
    """

    kind: ClassVar[str] = "compute"

    tile: XY
    cycles: float

    def nodes(self, mesh: Mesh2D) -> frozenset[XY]:
        return frozenset((self.tile,))


_OP_KINDS: dict[str, type[Op]] = {
    cls.kind: cls
    for cls in (UnicastOp, MulticastOp, ReductionOp, BarrierOp, ComputeOp)
}

COMM_KINDS = ("unicast", "multicast", "reduction")


def op_from_dict(d: dict) -> Op:
    kind = d.get("op")
    cls = _OP_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown program op kind {kind!r}")
    kw = {
        "id": int(d["id"]),
        "deps": tuple(int(x) for x in d.get("deps", ())),
        "start": float(d.get("start", 0.0)),
        "phase": int(d.get("phase", 0)),
    }
    if cls is UnicastOp:
        kw.update(src=_xy(d["src"]), dst=_xy(d["dst"]), nbytes=int(d["nbytes"]))
    elif cls is MulticastOp:
        kw.update(src=_xy(d["src"]), dst=_xy(d["dst"]),
                  x_mask=int(d.get("x_mask", 0)), y_mask=int(d.get("y_mask", 0)),
                  nbytes=int(d.get("nbytes", 0)))
    elif cls is ReductionOp:
        kw.update(sources=tuple(_xy(s) for s in d["sources"]), dst=_xy(d["dst"]),
                  nbytes=int(d["nbytes"]))
    elif cls is BarrierOp:
        kw.update(participants=tuple(_xy(s) for s in d["participants"]),
                  counter=_xy(d.get("counter", (0, 0))),
                  flavor=str(d.get("flavor", "")))
    else:  # ComputeOp
        kw.update(tile=_xy(d["tile"]), cycles=float(d["cycles"]))
    return cls(**kw)


def op_to_event(op: Op) -> TrafficEvent:
    """Flatten a traffic-expressible op back to a trace event."""
    if isinstance(op, UnicastOp):
        return TrafficEvent("unicast", phase=op.phase, start=op.start,
                            nbytes=op.nbytes, src=op.src, dst=op.dst)
    if isinstance(op, MulticastOp):
        return TrafficEvent("multicast", phase=op.phase, start=op.start,
                            nbytes=op.nbytes, src=op.src, dst=op.dst,
                            x_mask=op.x_mask, y_mask=op.y_mask)
    if isinstance(op, ReductionOp):
        return TrafficEvent("reduction", phase=op.phase, start=op.start,
                            nbytes=op.nbytes, dst=op.dst, sources=op.sources)
    if isinstance(op, BarrierOp):
        return TrafficEvent("barrier", phase=op.phase, start=op.start,
                            dst=op.counter, sources=op.participants,
                            flavor=op.flavor)
    raise ValueError(
        f"op #{op.id} ({op.kind}) has no trace-event representation; "
        "drop compute ops first (Program.comm_only())"
    )


def op_from_event(ev: TrafficEvent, id: int, deps: tuple[int, ...] = ()) -> Op:
    head = dict(id=id, deps=deps, start=ev.start, phase=ev.phase)
    if ev.kind == "unicast":
        return UnicastOp(src=_xy(ev.src), dst=_xy(ev.dst), nbytes=ev.nbytes, **head)
    if ev.kind == "multicast":
        return MulticastOp(src=_xy(ev.src), dst=_xy(ev.dst), x_mask=ev.x_mask,
                           y_mask=ev.y_mask, nbytes=ev.nbytes, **head)
    if ev.kind == "reduction":
        return ReductionOp(sources=tuple(_xy(s) for s in ev.sources),
                           dst=_xy(ev.dst), nbytes=ev.nbytes, **head)
    if ev.kind == "barrier":
        return BarrierOp(participants=tuple(_xy(s) for s in ev.sources),
                         counter=_xy(ev.dst), flavor=ev.flavor, **head)
    raise ValueError(f"unknown traffic event kind {ev.kind!r}")


@dataclasses.dataclass
class Program:
    """A DAG of collective/compute ops over a ``cols x rows`` mesh.

    The router-configuration stamps mirror trace schema v2 (``None`` =
    unspecified, execution falls back to the caller's params); they
    survive the v3 JSON round trip and the trace conversion both ways.
    """

    cols: int
    rows: int
    ops: list[Op] = dataclasses.field(default_factory=list)
    routing: Optional[str] = None
    num_vcs: Optional[int] = None
    vc_select: Optional[str] = None
    vc_map: Optional[tuple[tuple[str, int], ...]] = None
    # Fault pattern the program runs under (a faults.FaultSet, or None =
    # pristine mesh).  Serialized only when present, so fault-free
    # programs keep the exact historical v3 JSON bytes.
    faults: Optional[object] = None

    @property
    def mesh(self) -> Mesh2D:
        return Mesh2D(self.cols, self.rows)

    @property
    def num_phases(self) -> int:
        return max((op.phase for op in self.ops), default=-1) + 1

    def __len__(self) -> int:
        return len(self.ops)

    def validate(self) -> "Program":
        """Check DAG well-formedness: sequential ids, backward deps only."""
        mesh = self.mesh
        for i, op in enumerate(self.ops):
            if op.id != i:
                raise ValueError(f"op #{op.id} at position {i}: ids must be "
                                 "sequential (0, 1, ...)")
            for d in op.deps:
                if not 0 <= d < i:
                    raise ValueError(
                        f"op #{i} depends on #{d}: deps must reference "
                        "earlier ops (programs are DAGs by construction)")
            for node in op.nodes(mesh):
                if not mesh.contains(Coord(*node)):
                    raise ValueError(f"op #{i} touches {node}, outside the "
                                     f"{self.cols}x{self.rows} mesh")
        return self

    # -- serialization (trace schema v3) -----------------------------------

    def to_json(self, indent: int | None = None) -> str:
        d = {
            "version": PROGRAM_VERSION,
            "cols": self.cols,
            "rows": self.rows,
            "routing": self.routing,
            "num_vcs": self.num_vcs,
            "vc_select": self.vc_select,
            "vc_map": [list(p) for p in self.vc_map]
            if self.vc_map is not None else None,
            "ops": [op.to_dict() for op in self.ops],
        }
        if self.faults is not None:
            # Only when present: fault-free programs keep the exact
            # historical JSON bytes (golden sha256s depend on it).
            d["faults"] = self.faults.to_dict()
        return json.dumps(d, indent=indent)

    @staticmethod
    def from_json(s: str) -> "Program":
        d = json.loads(s)
        version = d.get("version", 1)
        if version in (1, 2):
            # Legacy flat trace: convert its phase structure to barrier
            # deps so it replays bit-identically through the program path.
            return from_trace(Trace.from_json(s))
        if version != PROGRAM_VERSION:
            raise ValueError(f"unsupported trace/program version {version!r}")
        if not isinstance(d.get("ops"), list):
            raise ValueError(
                "version 3 files serialize programs and need an 'ops' list "
                "(flat 'events' traces are schema v1/v2)")
        vc_map = d.get("vc_map")
        faults = d.get("faults")
        if faults is not None:
            from repro_torch.core.noc.faults.model import FaultSet

            faults = FaultSet.from_dict(faults)
        return Program(
            cols=int(d["cols"]),
            rows=int(d["rows"]),
            ops=[op_from_dict(o) for o in d["ops"]],
            routing=d.get("routing"),
            num_vcs=int(d["num_vcs"]) if d.get("num_vcs") is not None else None,
            vc_select=d.get("vc_select"),
            vc_map=tuple((str(c), int(vc)) for c, vc in vc_map)
            if vc_map is not None else None,
            faults=faults,
        ).validate()

    # -- trace interop ------------------------------------------------------

    def to_trace(self) -> Trace:
        """Flatten to a (schema v2) phase-list trace.

        Only phase-expressible programs flatten: a dep on an
        *earlier-phase* op is implied by phase serialization (barrier
        replay drains phase p-1 before p injects), and a barrier op
        depending on its own phase's traffic is exactly the flat barrier
        semantics — but a non-barrier op gated on a **same-phase** op
        carries ordering a flat trace cannot express (same-phase events
        replay concurrently), so flattening raises rather than silently
        dropping the edge.  :class:`ComputeOp` nodes (no flat-trace
        form) raise too.
        """
        for op in self.ops:
            if isinstance(op, BarrierOp):
                continue
            for d in op.deps:
                if self.ops[d].phase == op.phase:
                    raise ValueError(
                        f"op #{op.id} ({op.kind}) depends on same-phase op "
                        f"#{d} ({self.ops[d].kind}): flat traces replay "
                        "same-phase events concurrently, so this dependency "
                        "has no trace form — keep the program (schema v3) "
                        "and run it with run_program(mode='op')")
        return Trace(
            self.cols, self.rows,
            events=[op_to_event(op) for op in self.ops],
            routing=self.routing, num_vcs=self.num_vcs,
            vc_select=self.vc_select, vc_map=self.vc_map,
            faults=self.faults,
        )

    def to_events(self) -> list[TrafficEvent]:
        return [op_to_event(op) for op in self.ops]

    # -- filters ------------------------------------------------------------

    def filter(self, keep: Callable[[Op], bool]) -> "Program":
        """Subset program: drop ops failing ``keep``, rewiring dependencies
        *transitively* through dropped ops (a kept op that depended on a
        dropped op inherits the dropped op's own effective deps), and
        renumbering ids densely.  Phases and stamps are preserved."""
        new_id: dict[int, int] = {}
        repl: dict[int, tuple[int, ...]] = {}  # dropped id -> replacement ids
        ops: list[Op] = []

        def resolve(d: int) -> tuple[int, ...]:
            if d in new_id:
                return (new_id[d],)
            return repl[d]

        for op in self.ops:
            eff: list[int] = []
            for d in op.deps:
                for r in resolve(d):
                    if r not in eff:
                        eff.append(r)
            if keep(op):
                new_id[op.id] = len(ops)
                ops.append(dataclasses.replace(
                    op, id=len(ops), deps=tuple(eff)))
            else:
                repl[op.id] = tuple(eff)
        return Program(self.cols, self.rows, ops, routing=self.routing,
                       num_vcs=self.num_vcs, vc_select=self.vc_select,
                       vc_map=self.vc_map, faults=self.faults)

    def comm_only(self) -> "Program":
        """Fabric traffic only (computes dropped, deps rewired through)."""
        return self.filter(lambda op: not isinstance(op, ComputeOp))

    def compute_only(self) -> "Program":
        """Compute intervals only (comm/barriers dropped, deps rewired)."""
        return self.filter(lambda op: isinstance(op, ComputeOp))


def from_trace(trace: Trace) -> Program:
    """Phase→barrier-dep conversion of a legacy flat trace.

    Ops keep the event order (ids = event indices) and phase stamps, so
    the barrier/window execution modes reproduce ``replay()`` of the
    source trace bit-identically.  Dependency edges encode the phase
    serialization for the per-op mode: every op of phase ``p`` depends
    on the previous phase's fence — its barrier ops if it had any, else
    all of its ops (pure drain serialization, matching barrier replay).
    """
    n = len(trace.events)
    by_phase: dict[int, list[int]] = {}
    for i, ev in enumerate(trace.events):
        by_phase.setdefault(ev.phase, []).append(i)
    deps: list[tuple[int, ...]] = [()] * n
    fence: tuple[int, ...] = ()
    for phase in sorted(by_phase):
        idxs = by_phase[phase]
        comm = [i for i in idxs if trace.events[i].kind != "barrier"]
        barriers = [i for i in idxs if trace.events[i].kind == "barrier"]
        # Deps must reference earlier ids (ids = event indices); a trace
        # whose event list interleaves phases out of order simply loses
        # the forward edges — barrier/window modes never read deps, so
        # legacy replay is unaffected.
        for i in comm:
            deps[i] = tuple(j for j in fence if j < i)
        for i in barriers:
            deps[i] = tuple(j for j in fence if j < i) + tuple(
                j for j in comm if j < i)
        if barriers:
            fence = tuple(barriers)
        elif comm:
            fence = tuple(comm)
    ops = [
        op_from_event(ev, id=i, deps=deps[i])
        for i, ev in enumerate(trace.events)
    ]
    return Program(trace.cols, trace.rows, ops, routing=trace.routing,
                   num_vcs=trace.num_vcs, vc_select=trace.vc_select,
                   vc_map=trace.vc_map, faults=trace.faults)
