"""Traffic traces: capture, serialization, and contended replay.

A :class:`Trace` is a mesh-shape-stamped list of :class:`TrafficEvent`
records — unicasts, multicasts, reductions and barriers — organized into
*phases*.  Events within a phase share the fabric concurrently (their
``start`` offsets are relative to the phase start); a barrier event closes
the phase, and the next phase begins only after every stream of the
current one has drained plus the hardware-barrier round-trip.

Traces come from three places:

* a :class:`TraceRecorder` attached to a live ``NoCSim`` — every
  ``add_unicast`` / ``add_multicast`` / ``add_reduction`` / ``barrier_*``
  call is captured as it is issued (the cost paths of ``schedules.py``,
  ``summa.py`` and ``overlap.py`` emit through this hook),
* the synthetic generators in :mod:`repro_torch.core.noc.traffic.patterns`,
* a JSON file produced by :meth:`Trace.to_json` (round-trip tested).

Replaying a trace through :func:`replay` runs all phase-concurrent
streams over the *shared* link fabric, so the resulting completion cycles
include interference — unlike summing per-collective idle-network model
times, which is what the paper's microbenchmarks (and the analytical
models in ``noc/model.py``) report.  :func:`replay` is a thin shim over
the collective program IR: the trace is converted to a
:class:`~repro_torch.core.noc.program.Program` (phase→barrier-dep conversion)
and executed by :func:`~repro_torch.core.noc.program.run_program`, which owns
all phase-composition modes — the default ``mode='barrier'`` fully
serializes phases on fabric drain + barrier cost, ``mode='window'``
overlaps them (phase k+1 streams inject as soon as the phase-k streams
whose footprints intersect theirs drain; ``overlap='links'`` gates on
shared route edges under the configured policy instead of endpoint
tiles), and programs additionally support exact per-op dependency gating
(``mode='op'``).  Both trace modes are bit-identical to the historical
in-module implementations.  Schema v3 files (serialized programs) load
through :meth:`Trace.from_json` as long as they are flat-trace
expressible (no compute ops).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

from repro_torch.core.noc.netsim import NoCSim
from repro_torch.core.noc.params import NoCParams
from repro_torch.core.topology import Mesh2D, MultiAddress

KINDS = ("unicast", "multicast", "reduction", "barrier")


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """One fabric-level operation, serializable as a flat dict."""

    kind: str                       # one of KINDS
    phase: int = 0                  # barrier-separated epoch index
    start: float = 0.0              # injection cycle, relative to phase start
    nbytes: int = 0
    src: Optional[tuple[int, int]] = None       # unicast / multicast source
    dst: Optional[tuple[int, int]] = None       # unicast dst, reduction root,
                                                # multicast (dst, mask) base
    x_mask: int = 0                 # multicast masks
    y_mask: int = 0
    sources: tuple[tuple[int, int], ...] = ()   # reduction inputs / barrier
                                                # participants (dst = counter)
    flavor: str = ""                # barriers: "sw" | "hw" (default hw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["sources"] = [list(s) for s in self.sources]
        return d

    @staticmethod
    def from_dict(d: dict) -> "TrafficEvent":
        if d.get("kind") not in KINDS:
            raise ValueError(f"unknown traffic event kind {d.get('kind')!r}")
        return TrafficEvent(
            kind=d["kind"],
            phase=int(d.get("phase", 0)),
            start=float(d.get("start", 0.0)),
            nbytes=int(d.get("nbytes", 0)),
            src=tuple(d["src"]) if d.get("src") is not None else None,
            dst=tuple(d["dst"]) if d.get("dst") is not None else None,
            x_mask=int(d.get("x_mask", 0)),
            y_mask=int(d.get("y_mask", 0)),
            sources=tuple(tuple(s) for s in d.get("sources", ())),
            flavor=str(d.get("flavor", "")),
        )


TRACE_VERSION = 2


@dataclasses.dataclass
class Trace:
    cols: int
    rows: int
    events: list[TrafficEvent] = dataclasses.field(default_factory=list)
    # Router configuration the trace was captured under (schema v2).
    # ``None`` = unspecified: replay falls back to the caller's params
    # (whose defaults are XY / 1 VC / class-mapped), which is also how
    # version-less and v1 trace files load.  A TraceRecorder stamps the
    # live sim's full router configuration — policy, VC count, VC
    # selection mode and any explicit class map — so recorded traces
    # replay bit-identically under the configuration they were captured
    # with.
    routing: Optional[str] = None
    num_vcs: Optional[int] = None
    vc_select: Optional[str] = None
    vc_map: Optional[tuple[tuple[str, int], ...]] = None
    # Fault pattern the trace was captured under (a faults.FaultSet, or
    # None = pristine mesh), so degraded runs replay bit-identically.
    # Serialized only when present — fault-free traces keep the exact
    # historical JSON (and sha256 fingerprints).
    faults: Optional[object] = None

    @property
    def mesh(self) -> Mesh2D:
        return Mesh2D(self.cols, self.rows)

    @property
    def num_phases(self) -> int:
        return max((e.phase for e in self.events), default=-1) + 1

    def phase_events(self, phase: int) -> list[TrafficEvent]:
        return [e for e in self.events if e.phase == phase]

    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.events if e.kind != "barrier")

    def to_json(self, indent: int | None = None) -> str:
        d = {
            "version": TRACE_VERSION,
            "cols": self.cols,
            "rows": self.rows,
            "routing": self.routing,
            "num_vcs": self.num_vcs,
            "vc_select": self.vc_select,
            "vc_map": [list(p) for p in self.vc_map]
            if self.vc_map is not None else None,
            "events": [e.to_dict() for e in self.events],
        }
        if self.faults is not None:
            # Emitted only when present: fault-free traces serialize to
            # the exact historical bytes (golden sha256s depend on it).
            d["faults"] = self.faults.to_dict()
        return json.dumps(d, indent=indent)

    @staticmethod
    def from_json(s: str) -> "Trace":
        d = json.loads(s)
        version = d.get("version", 1)  # version-less files predate v1
        if version == 3:
            # Schema v3 is a serialized program; flatten it back to a
            # phase-list trace (raises if it contains compute ops, which
            # have no flat-trace form — load those via Program.from_json).
            from repro_torch.core.noc.program import Program

            return Program.from_json(s).to_trace()
        if version not in (1, 2):
            raise ValueError(f"unsupported trace version {version!r}")
        # v1 (and version-less) traces carry no router configuration:
        # the stamps stay None and replay applies its XY/1-VC parameter
        # defaults.
        v2 = version >= 2
        vc_map = d.get("vc_map") if v2 else None
        faults = d.get("faults") if v2 else None
        if faults is not None:
            from repro_torch.core.noc.faults.model import FaultSet

            faults = FaultSet.from_dict(faults)
        return Trace(
            cols=int(d["cols"]),
            rows=int(d["rows"]),
            events=[TrafficEvent.from_dict(e) for e in d["events"]],
            routing=d.get("routing") if v2 else None,
            num_vcs=int(d["num_vcs"]) if v2 and d.get("num_vcs")
            is not None else None,
            vc_select=d.get("vc_select") if v2 else None,
            vc_map=tuple((str(c), int(vc)) for c, vc in vc_map)
            if vc_map is not None else None,
            faults=faults,
        )


class TraceRecorder:
    """Captures stream-builder calls of a live ``NoCSim`` into a Trace.

    Attach with ``rec = TraceRecorder.attach(sim)``; every subsequent
    ``add_*`` call is appended to ``rec.trace``.  A ``barrier_sw`` /
    ``barrier_hw`` call records a barrier event and closes the current
    phase (mirroring the phase semantics of :func:`replay`).
    """

    def __init__(self, mesh: Mesh2D):
        self.trace = Trace(mesh.cols, mesh.rows)
        self.phase = 0

    @classmethod
    def attach(cls, sim: NoCSim) -> "TraceRecorder":
        rec = cls(sim.mesh)
        # Stamp the live router configuration so the trace replays
        # bit-identically under the configuration it was captured with
        # (schema v2).
        rec.trace.routing = sim.p.routing
        rec.trace.num_vcs = sim.p.num_vcs
        rec.trace.vc_select = sim.p.vc_select
        rec.trace.vc_map = sim.p.vc_map
        rec.trace.faults = sim.faults
        sim.recorders.append(rec)
        return rec

    def record(self, kind: str, **kw) -> None:
        if kind == "unicast":
            ev = TrafficEvent(
                "unicast", phase=self.phase, start=kw["start"],
                nbytes=kw["nbytes"], src=tuple(kw["src"]), dst=tuple(kw["dst"]),
            )
        elif kind == "multicast":
            ma: MultiAddress = kw["maddr"]
            ev = TrafficEvent(
                "multicast", phase=self.phase, start=kw["start"],
                nbytes=kw["nbytes"], src=tuple(kw["src"]), dst=tuple(ma.dst),
                x_mask=ma.x_mask, y_mask=ma.y_mask,
            )
        elif kind == "reduction":
            ev = TrafficEvent(
                "reduction", phase=self.phase, start=kw["start"],
                nbytes=kw["nbytes"], dst=tuple(kw["dst"]),
                sources=tuple(tuple(s) for s in kw["sources"]),
            )
        elif kind in ("barrier_sw", "barrier_hw"):
            ev = TrafficEvent(
                "barrier", phase=self.phase, dst=tuple(kw["counter"]),
                sources=tuple(tuple(s) for s in kw["participants"]),
                flavor=kind.removeprefix("barrier_"),
            )
            self.phase += 1
        else:
            raise ValueError(f"unknown record kind {kind!r}")
        self.trace.events.append(ev)


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Aggregate latency statistics over a set of streams/ops.

    Percentiles use the nearest-rank method on the sorted latencies, so
    they are exact sample values (deterministic, no interpolation) —
    what saturation sweeps and ``BENCH_routing.json`` report alongside
    the mean that a single hotspotted victim can hide behind.
    """

    count: int = 0
    mean: float = 0.0
    max: float = 0.0
    p50: float = 0.0
    p95: float = 0.0
    p99: float = 0.0

    @staticmethod
    def of(latencies) -> "StreamStats":
        lats = sorted(latencies)
        if not lats:
            return StreamStats()

        def pct(q: float) -> float:
            return lats[min(len(lats) - 1, max(0, math.ceil(q * len(lats)) - 1))]

        return StreamStats(
            count=len(lats),
            mean=sum(lats) / len(lats),
            max=lats[-1],
            p50=pct(0.50),
            p95=pct(0.95),
            p99=pct(0.99),
        )


@dataclasses.dataclass
class StreamResult:
    event: TrafficEvent
    inject_cycle: float    # absolute injection request cycle
    done_cycle: int        # absolute completion cycle

    @property
    def latency(self) -> float:
        return self.done_cycle - self.inject_cycle


@dataclasses.dataclass
class ReplayResult:
    makespan: int                       # last completion cycle overall
    streams: list[StreamResult]
    phase_end: list[float]              # fabric-drain + barrier end per phase

    @property
    def latencies(self) -> list[float]:
        return [s.latency for s in self.streams]

    def stats(self) -> StreamStats:
        return StreamStats.of(self.latencies)

    def mean_latency(self) -> float:
        lats = self.latencies
        return sum(lats) / len(lats) if lats else 0.0

    def max_latency(self) -> float:
        return max(self.latencies, default=0.0)


def replay(
    trace: Trace,
    params: NoCParams | None = None,
    max_cycles: int = 50_000_000,
    engine: str = "heap",
    mode: str = "barrier",
    routing: Optional[str] = None,
    num_vcs: Optional[int] = None,
    overlap: str = "tiles",
    telemetry=None,
) -> ReplayResult:
    """Run a trace through the simulator under shared-fabric contention.

    Thin shim over the collective program IR: the trace converts to a
    :class:`~repro_torch.core.noc.program.Program` via the phase→barrier-dep
    conversion and executes through
    :func:`~repro_torch.core.noc.program.run_program` — the single lowering
    path from workload description to engine streams.  Results are
    bit-identical to the historical in-module replay for both modes.

    ``mode='barrier'`` (default): phase k+1 starts only after *all* of
    phase k's streams have drained (plus the HW-barrier cost when the
    phase ends with a barrier event), so the result composes end-to-end
    workload time *with* interference.

    ``mode='window'``: sliding-window replay — each phase-k+1 stream is
    gated only on the phase-k streams whose footprints overlap its own,
    and injects as soon as those drain (no global barrier
    serialization).  ``overlap='tiles'`` (default) gates on shared
    endpoint tiles; ``overlap='links'`` gates on shared route edges
    under the effective routing policy (the policy-aware window).

    Router configuration: a trace stamped with ``routing`` / ``num_vcs``
    (schema v2, e.g. captured by a :class:`TraceRecorder`) replays under
    that configuration; the ``routing`` / ``num_vcs`` arguments override
    it (to re-route a recorded trace under a different policy); both
    fall back to ``params``.
    """
    from repro_torch.core.noc.program import from_trace, run_program

    res = run_program(
        from_trace(trace), params=params, max_cycles=max_cycles,
        engine=engine, mode=mode, overlap=overlap, routing=routing,
        num_vcs=num_vcs, telemetry=telemetry,
    )
    return result_to_replay(res)


def result_to_replay(res) -> ReplayResult:
    """Convert a :class:`~repro_torch.core.noc.program.ProgramResult` into the
    legacy :class:`ReplayResult` shape (phase-major stream order, barrier
    ops dropped) — shared by :func:`replay` and the compile-once sweep
    path."""
    from repro_torch.core.noc.program.ops import BarrierOp, op_to_event

    runs = sorted(
        (r for r in res.runs if not isinstance(r.op, BarrierOp)),
        key=lambda r: (r.op.phase, r.op.id),  # legacy phase-major order
    )
    return ReplayResult(
        makespan=res.makespan,
        streams=[
            StreamResult(op_to_event(r.op), r.inject_cycle, r.done_cycle)
            for r in runs
        ],
        phase_end=res.phase_end,
    )
