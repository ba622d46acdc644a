"""Lowering: compile a :class:`Program` into engine streams and run it.

One pass (:func:`run_program`) is now the single path from workload
description to simulation — ``traffic.trace.replay`` is a thin shim
that converts its trace to a program and calls here.  Three execution
modes interpret the same op DAG:

``mode='op'`` (programs' default)
    Exact per-op gating: every op becomes a stream whose ``gates`` are
    the streams of its ``deps`` (generalizing the window-replay gate
    machinery), so an op injects — at its own ``start`` offset — the
    cycle after the last dependency drains.  ``ComputeOp`` /
    ``BarrierOp`` lower to link-free timed streams
    (``NoCSim.add_timed``), which is what lets a double-buffered SUMMA
    program overlap iteration k+1's collectives with iteration k's tile
    GEMMs inside one contended simulation.

``mode='barrier'``
    The legacy phase-serialized semantics, bit-identical to historical
    ``replay()``: phases execute in order, each draining fully (plus
    the analytic cost of its barrier ops) before the next injects.
    Dependency edges are ignored; compute ops complete analytically at
    ``phase offset + start + cycles`` — the non-overlapped baseline a
    per-op run is compared against.

``mode='window'``
    Sliding-window phase overlap, bit-identical to the historical
    ``replay(mode='window')`` at ``overlap='tiles'``: each stream gates
    on the most recent earlier-phase streams whose footprints intersect
    its own.  ``overlap='links'`` is the policy-aware variant: the
    footprint is the stream's *actual route edges* under the configured
    routing policy (computed during lowering), so two streams whose
    tiles coincide but whose routes share no channel stop gating each
    other — the shared-link overlap the ROADMAP's policy-aware window
    item called for.

The result carries per-op completion cycles and latencies
(:class:`OpRun`) plus aggregate :class:`StreamStats` percentiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.noc.netsim import NoCSim
from repro_torch.core.noc.params import NoCParams
from repro_torch.core.noc.program.ops import (
    BarrierOp,
    ComputeOp,
    MulticastOp,
    Op,
    Program,
    ReductionOp,
    UnicastOp,
)
from repro_torch.core.noc.traffic.trace import StreamStats
from repro_torch.core.topology import Coord

MODES = ("op", "barrier", "window")
OVERLAPS = ("tiles", "links")


@dataclasses.dataclass(frozen=True)
class OpRun:
    """Completion record of one op (cycles are absolute)."""

    op: Op
    inject_cycle: float           # release + start offset
    done_cycle: float             # integer-valued for simulated ops

    @property
    def latency(self) -> float:
        return self.done_cycle - self.inject_cycle


@dataclasses.dataclass
class ProgramResult:
    makespan: float               # last comm/compute completion
    # Op/barrier modes cover every op in id order; window mode is
    # phase-major and omits barrier ops (they are dropped from the
    # window model entirely) — use run_of() for id-keyed access.
    runs: list[OpRun]
    phase_end: list[float]        # cumulative drain per phase stamp

    def run_of(self, op_id: int) -> OpRun:
        for r in self.runs:
            if r.op.id == op_id:
                return r
        raise KeyError(
            f"op #{op_id} has no run (window mode drops barrier ops; "
            "phase-less ids never execute in barrier mode)")

    @property
    def latencies(self) -> list[float]:
        return [r.latency for r in self.runs
                if not isinstance(r.op, BarrierOp)]

    def stats(self) -> StreamStats:
        """Latency percentiles over the comm/compute ops."""
        return StreamStats.of(self.latencies)


def effective_params(
    prog,
    params: NoCParams | None,
    routing: Optional[str],
    num_vcs: Optional[int],
) -> NoCParams:
    """Router configuration precedence: explicit argument > program/trace
    stamp > caller params (defaults: XY, 1 VC).

    The VC selection mode and class map have no explicit override
    arguments, so the stamp wins whenever present — except that a
    stamped ``vc_map`` is dropped when the effective VC count cannot
    hold it (an explicit ``num_vcs`` below the captured count
    re-configures the workload; classes fall back to the default map).
    """
    p = params or NoCParams()
    routing = routing if routing is not None else prog.routing
    num_vcs = num_vcs if num_vcs is not None else prog.num_vcs
    updates = {}
    if routing is not None and routing != p.routing:
        updates["routing"] = routing
    if num_vcs is not None and num_vcs != p.num_vcs:
        updates["num_vcs"] = num_vcs
    if prog.vc_select is not None and prog.vc_select != p.vc_select:
        updates["vc_select"] = prog.vc_select
    effective_vcs = num_vcs if num_vcs is not None else p.num_vcs
    if (
        prog.vc_map is not None
        and prog.vc_map != p.vc_map
        and all(vc < effective_vcs for _, vc in prog.vc_map)
    ):
        updates["vc_map"] = prog.vc_map
    # A program/trace captured on a faulted mesh replays under those
    # faults: like vc_select, there is no explicit override argument,
    # so the stamp wins whenever present (drop the stamp via
    # dataclasses.replace(prog, faults=None) to replay pristine).
    if prog.faults is not None and prog.faults != p.faults:
        updates["faults"] = prog.faults
    return dataclasses.replace(p, **updates) if updates else p


def add_op(sim: NoCSim, op: Op, start: float, params: NoCParams):
    """Lower one op onto a live simulator; returns its stream."""
    if isinstance(op, UnicastOp):
        return sim.add_unicast(Coord(*op.src), Coord(*op.dst), op.nbytes,
                               start=start)
    if isinstance(op, MulticastOp):
        return sim.add_multicast(Coord(*op.src), op.maddr, op.nbytes,
                                 start=start)
    if isinstance(op, ReductionOp):
        return sim.add_reduction([Coord(*s) for s in op.sources],
                                 Coord(*op.dst), op.nbytes, start=start)
    if isinstance(op, ComputeOp):
        return sim.add_timed(Coord(*op.tile), op.cycles, start=start)
    if isinstance(op, BarrierOp):
        return sim.add_timed(Coord(*op.counter), op.cost(params), start=start)
    raise ValueError(f"cannot lower op kind {op.kind!r}")


def run_program(
    prog: Program,
    params: NoCParams | None = None,
    *,
    max_cycles: int = 50_000_000,
    engine: str = "heap",
    mode: str = "op",
    overlap: str = "tiles",
    routing: Optional[str] = None,
    num_vcs: Optional[int] = None,
    telemetry=None,
) -> ProgramResult:
    """Execute a program under shared-fabric contention (see module doc).

    ``telemetry`` attaches a :class:`~repro_torch.core.noc.telemetry.Collector`
    to the run's sim (every mode keeps the whole program on one sim) and
    records per-op lifecycle spans on it when the run completes."""
    if mode not in MODES:
        raise ValueError(f"unknown replay mode {mode!r}; one of {MODES}")
    if overlap not in OVERLAPS:
        raise ValueError(f"unknown overlap {overlap!r}; one of {OVERLAPS}")
    # Builder/from_json-produced programs are pre-validated, but Program
    # is a public dataclass: a hand-built op list with, say, a negative
    # dep id would otherwise gate on the wrong stream via negative
    # indexing instead of raising.
    prog.validate()
    p = effective_params(prog, params, routing, num_vcs)
    if prog.routing is not None:
        from repro_torch.core.noc.faults.repair import fast_min_vcs

        need = fast_min_vcs(p.routing, prog.mesh)
        if p.num_vcs < need:
            import warnings

            warnings.warn(
                f"trace/program stamped with routing policy {p.routing!r}, "
                f"which is not deadlock-free at num_vcs={p.num_vcs} "
                f"(needs >= {need} VCs on {prog.cols}x{prog.rows}); "
                "re-run with num_vcs >= that, or expect the engines' "
                "stuck detection to raise on a deadlocked schedule",
                RuntimeWarning,
                stacklevel=2,
            )
    if mode == "op":
        res = _run_op(prog, p, max_cycles, engine, telemetry=telemetry)
    elif mode == "window":
        res = _run_window(prog, p, max_cycles, engine, overlap,
                          telemetry=telemetry)
    else:
        res = _run_barrier(prog, p, max_cycles, engine, telemetry=telemetry)
    if telemetry is not None:
        telemetry.record_program(res)
    return res


def _phase_end(prog: Program, runs: list[OpRun]) -> list[float]:
    """Cumulative per-phase drain times from per-op completions."""
    n = prog.num_phases
    end = [0.0] * n
    for r in runs:
        end[r.op.phase] = max(end[r.op.phase], r.done_cycle)
    for k in range(1, n):
        end[k] = max(end[k], end[k - 1])
    return end


# ---------------------------------------------------------------------------
# mode='op': exact per-op dependency gating, one contended run.
# ---------------------------------------------------------------------------


def _run_op(prog, p, max_cycles, engine, telemetry=None) -> ProgramResult:
    sim = NoCSim(prog.mesh, p)
    streams: list = []
    for op in prog.ops:
        st = add_op(sim, op, op.start, p)
        if op.deps:
            st.gates = [streams[d] for d in op.deps]
        streams.append(st)
    sim.run(max_cycles=max_cycles, engine=engine, telemetry=telemetry)
    runs = []
    for op, st in zip(prog.ops, streams):
        t0 = st._t0() or 0  # gates all drained after a successful run
        runs.append(OpRun(op, t0 + op.start, st.done_cycle))
    makespan = max(
        (r.done_cycle for r in runs if not isinstance(r.op, BarrierOp)),
        default=0,
    )
    return ProgramResult(makespan, runs, _phase_end(prog, runs))


# ---------------------------------------------------------------------------
# mode='barrier': phase-serialized legacy replay semantics.
# ---------------------------------------------------------------------------


def _run_barrier(prog, p, max_cycles, engine, add=add_op,
                 start_of=None, telemetry=None) -> ProgramResult:
    """Phase-serialized execution.  ``add`` lowers one op onto the live
    sim — the default builds streams from scratch; the compile-once path
    (:class:`CompiledWorkload`) passes an adder that instantiates cached
    stream specs.  ``start_of`` overrides per-op start offsets (how
    sweeps swap the injection rate without rebuilding the program)."""
    sim = NoCSim(prog.mesh, p)
    runs: list[tuple[int, OpRun]] = []
    phase_end: list[float] = []
    offset = 0.0
    by_phase: dict[int, list[Op]] = {}
    for op in prog.ops:
        by_phase.setdefault(op.phase, []).append(op)
    for phase in range(prog.num_phases):
        added: list[tuple[Op, object, float]] = []
        analytic: list[tuple[Op, float]] = []
        barrier_cost = 0.0
        for op in by_phase.get(phase, ()):
            if isinstance(op, BarrierOp):
                # The barrier's own fabric cost is the analytical model
                # of its flavor; it serializes the phase boundary.
                barrier_cost = max(barrier_cost, op.cost(p))
                continue
            start = offset + (op.start if start_of is None else start_of(op))
            if isinstance(op, ComputeOp):
                # Compute is analytic here: the barrier baseline fully
                # serializes phases, so in-phase contention modeling of
                # link-free intervals adds nothing.
                analytic.append((op, start))
                continue
            st = add(sim, op, start, p)
            added.append((op, st, start))
        done: float = sim.run(max_cycles=max_cycles, engine=engine,
                              telemetry=telemetry)
        for op, st, start in added:
            runs.append((op.id, OpRun(op, start, st.done_cycle)))
        for op, start in analytic:
            runs.append((op.id, OpRun(op, start, start + op.cycles)))
            done = max(done, start + op.cycles)
        # max(): a phase that adds no streams (barrier-only, or a gap in
        # phase numbering) must stack on the accumulated offset — ``done``
        # alone would rewind it to the last stream completion.
        offset = max(offset, done) + barrier_cost
        phase_end.append(offset)
        for op in by_phase.get(phase, ()):
            if isinstance(op, BarrierOp):
                runs.append((op.id, OpRun(op, offset - barrier_cost, offset)))
    runs.sort(key=lambda t: t[0])
    ordered = [r for _, r in runs]
    makespan = max(
        (r.done_cycle for r in ordered if not isinstance(r.op, BarrierOp)),
        default=0,
    )
    return ProgramResult(makespan, ordered, phase_end)


# ---------------------------------------------------------------------------
# mode='window': sliding-window phase overlap (tile or link footprints).
# ---------------------------------------------------------------------------


def _run_window(prog, p, max_cycles, engine, overlap,
                telemetry=None) -> ProgramResult:
    """One contended run with cross-phase footprint gating.

    Every non-barrier op becomes a stream up front; each stream gates,
    per footprint element it touches, on the *most recent* earlier-phase
    streams that touched that element, so it injects (at its own
    ``start`` offset) the cycle after the last of those drains.
    Tracking the latest toucher — not just the immediately preceding
    phase — keeps the dependency chain transitive.  Streams of the same
    phase stay concurrent; barrier ops are dropped — the window model is
    exactly "no global barrier, per-element double-buffered handoff".

    ``overlap='tiles'`` footprints are the op's endpoint tiles (the
    historical, policy-blind gate).  ``overlap='links'`` footprints are
    the physical-link edges of the stream actually constructed under the
    configured routing policy, so the gate tracks true channel sharing —
    streams that only meet at a tile (or link-free timed ops) do not
    gate; use ``mode='op'`` deps when the handoff itself must serialize.
    """
    mesh = prog.mesh
    sim = NoCSim(mesh, p)
    added: list[tuple[Op, object]] = []
    # footprint element -> ALL streams of the most recent phase that
    # touched it (two same-phase streams legitimately share elements; a
    # later stream must wait for every one of them).
    last_touch: dict = {}
    by_phase: dict[int, list[Op]] = {}
    for op in prog.ops:
        by_phase.setdefault(op.phase, []).append(op)
    for phase in range(prog.num_phases):
        cur: list[tuple[frozenset, object]] = []
        for op in by_phase.get(phase, ()):
            if isinstance(op, BarrierOp):
                continue
            st = add_op(sim, op, op.start, p)
            if overlap == "links":
                # Physical channels only: self-edges (tile-local
                # inject/eject, timed ops) model port occupancy, not
                # link contention — two streams that merely meet at a
                # tile no longer gate each other here (that is what
                # 'tiles' mode expresses).
                foot = frozenset(e for e in st.edges() if e[0] != e[1])
            else:
                foot = op.nodes(mesh)
            gates = {}
            for el in foot:
                for g in last_touch.get(el, ()):
                    gates[id(g)] = g
            st.gates = list(gates.values())
            added.append((op, st))
            cur.append((foot, st))
        cur_touch: dict = {}
        for foot, st in cur:  # same-phase streams do not gate each other
            for el in foot:
                cur_touch.setdefault(el, []).append(st)
        last_touch.update(cur_touch)
    sim.run(max_cycles=max_cycles, engine=engine, telemetry=telemetry)
    runs = []
    for op, st in added:
        t0 = st._t0() or 0  # gates all drained after a successful run
        runs.append(OpRun(op, t0 + op.start, st.done_cycle))
    makespan = max((r.done_cycle for r in runs), default=0)
    return ProgramResult(makespan, runs, _phase_end(prog, runs))


# ---------------------------------------------------------------------------
# Compile-once workloads: cache the lowering, swap the injection clock.
# ---------------------------------------------------------------------------


class CompiledWorkload:
    """One (mesh, params, program) lowered once, runnable many times.

    Compiling a program resolves everything start-independent about its
    streams — routes, multicast fork / reduction join trees, the
    prereq/group graphs, virtual channels, packet ids, and the compiled
    unit records (:class:`~repro_torch.core.noc.netsim.StreamSpec`, whose unit
    topology is shared across instantiations).  ``run`` then executes the
    barrier-mode semantics bit-identically to
    ``run_program(mode='barrier')`` while skipping all of that per call:
    each op instantiates a fresh stream from its cached spec with only
    the inject ``start`` recomputed.  ``start_of`` overrides per-op start
    offsets — that is how ``traffic.sweep`` replays the same seeded
    packet population across injection rates without re-lowering
    (composing with its ``workers=N`` process fan-out: a worker compiles
    once and amortizes over its chunk of sweep points).

    Packet ids are consumed at compile time in the exact order the
    direct path consumes them, so pid-keyed routing (o1turn) and
    packet-mode VC slicing agree with uncompiled execution.
    """

    def __init__(
        self,
        prog: Program,
        params: NoCParams | None = None,
        routing: Optional[str] = None,
        num_vcs: Optional[int] = None,
    ):
        prog.validate()
        self.prog = prog
        self.p = effective_params(prog, params, routing, num_vcs)
        scratch = NoCSim(prog.mesh, self.p)
        self._specs: dict[int, object] = {}
        by_phase: dict[int, list[Op]] = {}
        for op in prog.ops:
            by_phase.setdefault(op.phase, []).append(op)
        for phase in range(prog.num_phases):
            for op in by_phase.get(phase, ()):
                if isinstance(op, (BarrierOp, ComputeOp)):
                    continue  # analytic in barrier mode — nothing to cache
                if isinstance(op, UnicastOp):
                    spec = scratch.unicast_spec(
                        Coord(*op.src), Coord(*op.dst), op.nbytes)
                elif isinstance(op, MulticastOp):
                    spec = scratch.multicast_spec(
                        Coord(*op.src), op.maddr, op.nbytes)
                elif isinstance(op, ReductionOp):
                    spec = scratch.reduction_spec(
                        [Coord(*s) for s in op.sources], Coord(*op.dst),
                        op.nbytes)
                else:  # pragma: no cover - defensive
                    raise ValueError(f"cannot compile op kind {op.kind!r}")
                self._specs[op.id] = spec

    def _add(self, sim: NoCSim, op: Op, start: float, p: NoCParams):
        return self._specs[op.id].instantiate(sim, start)

    def fingerprint(self, engine: str = "heap") -> str:
        """Canonical sha256 identity of this compiled workload — what the
        service layer's compile cache and result memo key on (see
        :mod:`repro_torch.core.noc.fingerprint`): the program's schema-v3
        serialization, the *effective* parameters, and the engine."""
        from repro_torch.core.noc.fingerprint import workload_fingerprint

        return workload_fingerprint(self.prog, self.p, engine=engine)

    def run(
        self,
        *,
        max_cycles: int = 50_000_000,
        engine: str = "heap",
        start_of=None,
        telemetry=None,
    ) -> ProgramResult:
        """Execute the compiled program (barrier-mode semantics)."""
        res = _run_barrier(
            self.prog, self.p, max_cycles, engine,
            add=self._add, start_of=start_of, telemetry=telemetry,
        )
        if telemetry is not None:
            telemetry.record_program(res)
        return res


def compile_workload(
    source,
    params: NoCParams | None = None,
    routing: Optional[str] = None,
    num_vcs: Optional[int] = None,
) -> CompiledWorkload:
    """Compile a :class:`Program` or a legacy :class:`Trace` once."""
    if not isinstance(source, Program):
        from repro_torch.core.noc.program.ops import from_trace

        source = from_trace(source)
    return CompiledWorkload(source, params=params, routing=routing,
                            num_vcs=num_vcs)
