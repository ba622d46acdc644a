"""Opt-in fabric telemetry collection: counters, spans, timeseries.

A :class:`Collector` attaches to a sim via ``NoCSim.run(telemetry=...)``
and observes every beat-advance the engines perform.  It never feeds
back into simulation — attaching one changes no arrival, completion
cycle or arbitration decision, which is what keeps the engines'
bit-identity invariant intact with telemetry on or off.

Counting is *unit-granular*: one fire of a stream unit crosses each of
the unit's edges exactly once, so every engine reports fires at the
granularity it already works at and the totals agree exactly:

* the ``cycle``/``event`` engines call :meth:`Collector.count_group`
  per advanced fork group (a unit, identified by its first edge);
* the ``heap`` engine accumulates per-unit fire counts in a flat array
  and folds them once at run exit (:meth:`add_stream_fires`);
* the ``shard`` engine's regions accumulate per-fragment counts and
  flush them with each epoch reply; the coordinator folds exactly one
  copy per simulated epoch (:meth:`add_unit_fires`), so worker
  recovery/degradation replays — whose replies are discarded — are
  recomputed and discarded along with the rest of the reply.

Edges classify once per (run, stream) into physical links (busy +
retry counters, per VC), inject self-edges (per-tile inject totals) and
final/sink edges (per-tile eject totals); link-free timed streams
(compute / barrier intervals) are not traffic and count nowhere.

Spans and timeseries are *derived lazily* from the attached sim's
arrival state — valid because every execution path (including the
program runner's barrier mode and checkpoint restore) keeps all streams
of one logical run on one sim.  Only the counters, fault-event
annotations and program-op spans are collector state proper; they are
what :meth:`state_dict` serializes for checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.noc.telemetry.stats import FabricStats
from repro_torch.core.topology import Coord


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Collector knobs.  ``window`` is the timeseries sampling width in
    cycles; ``topk`` the default hot-link report length;
    ``region_grid`` the occupancy partition (None = 2x2, clamped to the
    mesh)."""

    window: int = 64
    topk: int = 10
    region_grid: Optional[tuple[int, int]] = None


class Collector:
    """Accumulates fabric counters across one or more run segments."""

    def __init__(self, config: TelemetryConfig | None = None):
        self.config = config or TelemetryConfig()
        # (link, VC) -> busy beats; link = (Coord a, Coord b), a != b.
        self.link_busy: dict = {}
        # Subset of busy crossings that paid a flaky-link retry penalty.
        self.link_retries: dict = {}
        self.tile_inject: dict = {}    # Coord -> beats injected at tile
        self.tile_eject: dict = {}     # Coord -> beats delivered at tile
        self.annotations: list = []    # (cycle, kind, detail) instants
        self.ops: list = []            # (label, lane, start, end) op spans
        # (name, t, value) counter samples — service-level gauges (queue
        # depth, slot occupancy, cache hit rate).  Deliberately NOT part
        # of state_dict(): checkpoints predate this field and their
        # payload bytes (hence fingerprints) must stay stable.
        self.counter_samples: list = []
        self._sim = None
        self._faults = None
        self._flaky_memo: dict = {}
        # Per-run classification cache keyed on id(stream): cleared at
        # every run start so recycled ids never alias across sims.
        self._ucache: dict = {}

    # -- lifecycle ---------------------------------------------------------

    def begin(self, sim) -> None:
        """Bind to ``sim`` at run start (``NoCSim.run`` calls this).
        Counters persist across calls — a resumed or multi-phase run
        keeps accumulating into the same totals."""
        # Classification is cached per id(stream).  Streams stay alive on
        # sim.streams for the sim's whole lifetime, so within one sim the
        # ids never recycle and the cache survives multi-phase / resumed
        # runs; a *different* sim (or a changed fault set — mid-run fault
        # events re-lower streams in place) invalidates it.
        if sim is not self._sim or sim.faults is not self._faults:
            self._flaky_memo = {}
            self._ucache = {}
        self._sim = sim
        self._faults = sim.faults

    # -- classification ----------------------------------------------------

    def _is_flaky(self, a, b) -> bool:
        key = (a, b)
        v = self._flaky_memo.get(key)
        if v is None:
            v = (self._faults is not None
                 and self._faults.flaky_penalty(a, b) != 0)
            self._flaky_memo[key] = v
        return v

    def _classify(self, s) -> tuple:
        """Per-unit counting recipe for stream ``s``: a list (by global
        unit index) and a first-edge lookup (the cycle/event engines
        identify an advanced group by its first edge) of
        ``(links, flaky_links, inject_tiles, eject_tiles)`` tuples."""
        key = id(s)
        cached = self._ucache.get(key)
        if cached is not None:
            return cached
        s._ensure_units()
        vc = s.vc
        inj = s.inject
        fins = s._finals_set
        # A stream with no physical link anywhere (timed compute/barrier
        # intervals) is tile occupancy, not traffic: count nothing.
        link_free = all(
            a == b for u in s._units for (a, b) in u
        )
        per_unit = []
        by_first = {}
        for u in s._units:
            links: list = []
            flaky: list = []
            inj_tiles: list = []
            ej_tiles: list = []
            if not link_free:
                for e in u:
                    a, b = e
                    if a != b and b.x >= 0 and b.y >= 0:
                        links.append((e, vc))
                        if self._is_flaky(a, b):
                            flaky.append((e, vc))
                    elif a != b:
                        # Sink pseudo-edge (reduction eject at a source
                        # destination): delivery at the real endpoint.
                        ej_tiles.append(a)
                    else:
                        if e in inj:
                            inj_tiles.append(a)
                        if e in fins:
                            ej_tiles.append(a)
            cls = (tuple(links), tuple(flaky),
                   tuple(inj_tiles), tuple(ej_tiles))
            by_first[u[0]] = cls
            per_unit.append(cls)
        out = (per_unit, by_first)
        self._ucache[key] = out
        return out

    def _apply(self, cls, n: int) -> None:
        links, flaky, inj_tiles, ej_tiles = cls
        if links:
            lb = self.link_busy
            for k in links:
                lb[k] = lb.get(k, 0) + n
        if flaky:
            lr = self.link_retries
            for k in flaky:
                lr[k] = lr.get(k, 0) + n
        if inj_tiles:
            ti = self.tile_inject
            for c in inj_tiles:
                ti[c] = ti.get(c, 0) + n
        if ej_tiles:
            te = self.tile_eject
            for c in ej_tiles:
                te[c] = te.get(c, 0) + n

    # -- engine feeds ------------------------------------------------------

    def count_group(self, s, group) -> None:
        """One fork group of ``s`` advanced one beat (cycle/event
        engines; the group is a unit, identified by its first edge)."""
        self._apply(self._classify(s)[1][group[0]], 1)

    def add_stream_fires(self, s, fires) -> None:
        """Fold a heap-engine run's per-unit fire counts for ``s``."""
        per_unit = self._classify(s)[0]
        for ui, n in enumerate(fires):
            if n:
                self._apply(per_unit[ui], n)

    def add_unit_fires(self, s, unit: int, n: int) -> None:
        """Fold ``n`` fires of global unit ``unit`` (shard epoch reply)."""
        self._apply(self._classify(s)[0][unit], n)

    # -- annotations and op spans ------------------------------------------

    def annotate(self, cycle: int, kind: str, detail: str) -> None:
        """Record an instantaneous event (fault arrival, re-lowering) on
        the timeline."""
        self.annotations.append((int(cycle), str(kind), str(detail)))

    def sample_counter(self, name: str, t: float, value: float) -> None:
        """Record one sample of a named gauge (exported as a Perfetto
        counter track).  The service scheduler feeds its
        ``service.queue_depth`` / ``service.slots_busy`` /
        ``service.cache_hit_rate`` tracks — plus ``service.store_hits``
        and ``service.store_flushes`` when a durable result store is
        attached — through this path."""
        self.counter_samples.append((str(name), float(t), float(value)))

    def last_counter(self, name: str):
        """Latest sampled value of the named counter track, or ``None``
        if it was never sampled (e.g. store tracks on a store-less
        service)."""
        for n, _t, value in reversed(self.counter_samples):
            if n == name:
                return value
        return None

    def record_program(self, res) -> None:
        """Record per-op lifecycle spans from a
        :class:`~repro_torch.core.noc.program.lower.ProgramResult` — compute
        and barrier ops land in the compute lane, traffic ops in the
        comm lane."""
        for r in res.runs:
            op = r.op
            kind = getattr(op, "kind", "op")
            lane = "compute" if kind in ("compute", "barrier") else "comm"
            self.ops.append((
                f"{kind}#{getattr(op, 'id', '?')}", lane,
                float(r.inject_cycle), float(r.done_cycle),
            ))

    # -- derived views -----------------------------------------------------

    def makespan(self) -> int:
        sim = self._sim
        if sim is None:
            return 0
        done = [s.done_cycle for s in sim.streams if s.done_cycle is not None]
        return max(done, default=0)

    def stream_spans(self) -> list[dict]:
        """Per-stream lifecycle intervals derived from the attached
        sim: created (gate release / time origin), first beat, last
        arrival, done."""
        sim = self._sim
        if sim is None:
            return []
        out = []
        for i, s in enumerate(sim.streams):
            if s.gates:
                dones = [g.done_cycle for g in s.gates]
                created = (None if any(d is None for d in dones)
                           else max(dones) + 1)
            else:
                created = 0
            first = last = None
            for arr in s.arrivals.values():
                if arr:
                    if first is None or arr[0] < first:
                        first = arr[0]
                    if last is None or arr[-1] > last:
                        last = arr[-1]
            out.append({
                "index": i,
                "kind": s.origin[0] if s.origin else "stream",
                "vc": s.vc,
                "created": created,
                "first_beat": first,
                "last_arrival": last,
                "done": s.done_cycle,
            })
        return out

    def _region_grid(self) -> tuple[int, int]:
        sim = self._sim
        gx, gy = self.config.region_grid or (2, 2)
        return (max(1, min(gx, sim.mesh.cols)),
                max(1, min(gy, sim.mesh.rows)))

    def timeseries(self, window: Optional[int] = None) -> list[dict]:
        """Windowed samples over the run: live-stream count, offered vs
        delivered beats, and per-region busy-beat occupancy.  Offered
        counts beats whose inject schedule makes them available inside
        the window; delivered counts final-edge arrivals — the gap
        between the two curves is queueing, i.e. saturation onset."""
        sim = self._sim
        if sim is None:
            return []
        w = window or self.config.window
        horizon = self.makespan() + 1
        nwin = max(1, -(-horizon // w))
        live = [0] * nwin
        offered = [0] * nwin
        delivered = [0] * nwin
        gx, gy = self._region_grid()
        cols, rows = sim.mesh.cols, sim.mesh.rows
        occupancy: list[dict] = [{} for _ in range(nwin)]
        for s in sim.streams:
            if s.gates:
                dones = [g.done_cycle for g in s.gates]
                t0 = None if any(d is None for d in dones) else max(dones) + 1
            else:
                t0 = 0
            link_free = True
            first = None
            for e, arr in s.arrivals.items():
                if arr and (first is None or arr[0] < first):
                    first = arr[0]
                a, b = e
                if a != b and 0 <= b.x and 0 <= b.y:
                    link_free = False
                    rid = (a.y * gy // rows) * gx + (a.x * gx // cols)
                    for t in arr:
                        occ = occupancy[min(t // w, nwin - 1)]
                        occ[rid] = occ.get(rid, 0) + 1
            # Live interval: release (or first observed beat) .. done.
            start = t0 if t0 is not None else first
            if start is not None:
                end = s.done_cycle if s.done_cycle is not None else horizon - 1
                for wi in range(min(start // w, nwin - 1),
                                min(end // w, nwin - 1) + 1):
                    live[wi] += 1
            # Offered: source-side beat availability per inject schedule.
            if not link_free and t0 is not None:
                for e, (st_off, rate) in s.inject.items():
                    for b in range(s.n_beats):
                        avail = math.ceil(t0 + st_off + b * rate)
                        if avail < horizon:
                            offered[avail // w] += 1
            # Delivered: final-edge arrivals.
            if not link_free:
                for e in s.finals:
                    for t in s.arrivals.get(e, ()):
                        delivered[min(t // w, nwin - 1)] += 1
        beat_bytes = sim.p.beat_bytes
        return [
            {
                "t0": wi * w,
                "live_streams": live[wi],
                "offered_beats": offered[wi],
                "delivered_beats": delivered[wi],
                "offered_bytes": offered[wi] * beat_bytes,
                "delivered_bytes": delivered[wi] * beat_bytes,
                "region_busy": dict(sorted(occupancy[wi].items())),
            }
            for wi in range(nwin)
        ]

    def stats(self) -> FabricStats:
        sim = self._sim
        return FabricStats(
            cols=sim.mesh.cols if sim is not None else 0,
            rows=sim.mesh.rows if sim is not None else 0,
            makespan=self.makespan(),
            link_busy=dict(self.link_busy),
            link_retries=dict(self.link_retries),
            tile_inject=dict(self.tile_inject),
            tile_eject=dict(self.tile_eject),
        )

    # -- checkpoint serialization ------------------------------------------

    def state_dict(self) -> dict:
        """JSON-ready collector state (counters, annotations, op spans)
        with deterministic ordering — what checkpoints embed.  Spans and
        timeseries are derived views and are not serialized."""

        def links(d: dict) -> list:
            return sorted(
                [a.x, a.y, b.x, b.y, vc, n]
                for ((a, b), vc), n in d.items()
            )

        def tiles(d: dict) -> list:
            return sorted([c.x, c.y, n] for c, n in d.items())

        grid = self.config.region_grid
        return {
            "config": {
                "window": self.config.window,
                "topk": self.config.topk,
                "region_grid": list(grid) if grid is not None else None,
            },
            "link_busy": links(self.link_busy),
            "link_retries": links(self.link_retries),
            "tile_inject": tiles(self.tile_inject),
            "tile_eject": tiles(self.tile_eject),
            "annotations": [list(a) for a in self.annotations],
            "ops": [list(o) for o in self.ops],
        }

    @classmethod
    def from_state(cls, state: dict) -> "Collector":
        cfg = state["config"]
        grid = cfg.get("region_grid")
        col = cls(TelemetryConfig(
            window=cfg["window"], topk=cfg["topk"],
            region_grid=tuple(grid) if grid is not None else None,
        ))
        for ax, ay, bx, by, vc, n in state["link_busy"]:
            col.link_busy[((Coord(ax, ay), Coord(bx, by)), vc)] = n
        for ax, ay, bx, by, vc, n in state["link_retries"]:
            col.link_retries[((Coord(ax, ay), Coord(bx, by)), vc)] = n
        for x, y, n in state["tile_inject"]:
            col.tile_inject[Coord(x, y)] = n
        for x, y, n in state["tile_eject"]:
            col.tile_eject[Coord(x, y)] = n
        col.annotations = [tuple(a) for a in state["annotations"]]
        col.ops = [tuple(o) for o in state["ops"]]
        return col
