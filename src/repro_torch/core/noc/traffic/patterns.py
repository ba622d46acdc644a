"""Deterministic, seedable synthetic workload generators.

Classic NoC evaluation patterns (uniform-random, transpose,
bit-complement, bit-reversal, hotspot, neighbor, all-to-all) plus
*collective storms* that replay the paper's SUMMA / FCL phase structure —
concurrent row-multicasts, column-reductions and barriers — as stream
batches at a configurable injection rate.

All generators return a :class:`~repro_torch.core.noc.traffic.trace.Trace`;
nothing touches a simulator here, so workloads can be generated,
serialized and replayed independently.

Injection model: each node draws ``packets_per_node`` unit-rate
exponential inter-arrival gaps from a seeded PRNG, and the gaps are
scaled by ``1 / rate`` (packets per node per cycle).  Because the unit
gaps and destinations are drawn *once* per seed, sweeping the injection
rate rescales the same packet population in time — which keeps
saturation curves comparable point-to-point and monotone.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.core.topology import (
    Coord,
    Mesh2D,
    Submesh,
    bit_complement_coord,
    bit_reversal_coord,
    neighbor_coord,
    transpose_coord,
)
from repro_torch.core.noc.traffic.trace import Trace, TrafficEvent

PATTERNS = (
    "uniform",
    "transpose",
    "bit_complement",
    "bit_reversal",
    "hotspot",
    "neighbor",
    "all_to_all",
)


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    """A synthetic workload: pattern + injection process."""

    pattern: str = "uniform"
    rate: float = 0.01             # packets / node / cycle (offered load)
    nbytes: int = 256              # payload per packet (4 beats)
    packets_per_node: int = 4
    seed: int = 0
    hotspot: tuple[int, int] = (0, 0)
    hotspot_frac: float = 0.5      # fraction of packets aimed at the hotspot

    def __post_init__(self):
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {self.pattern!r}; one of {PATTERNS}")
        if self.rate <= 0:
            raise ValueError(f"injection rate must be > 0, got {self.rate}")


def _destination(
    mesh: Mesh2D, cfg: SyntheticConfig, src: Coord, rng: random.Random
) -> Optional[Coord]:
    """Deterministic or drawn destination for one packet; None = no packet.

    The PRNG is consumed identically regardless of the outcome so that
    fixed-point sources do not shift the stream of draws of later nodes.
    """
    if cfg.pattern == "uniform":
        dst = mesh.coord_of(rng.randrange(mesh.num_tiles))
    elif cfg.pattern == "hotspot":
        u, nid = rng.random(), rng.randrange(mesh.num_tiles)
        dst = Coord(*cfg.hotspot) if u < cfg.hotspot_frac else mesh.coord_of(nid)
    elif cfg.pattern == "transpose":
        dst = transpose_coord(mesh, src)
    elif cfg.pattern == "bit_complement":
        dst = bit_complement_coord(mesh, src)
    elif cfg.pattern == "bit_reversal":
        dst = bit_reversal_coord(mesh, src)
    elif cfg.pattern == "neighbor":
        dst = neighbor_coord(mesh, src)
    else:  # pragma: no cover - all_to_all handled by synthetic_trace
        raise ValueError(cfg.pattern)
    return None if dst == src else dst


@dataclasses.dataclass(frozen=True)
class SyntheticPopulation:
    """The rate-independent part of a synthetic workload.

    Per source node, the seeded unit-rate inter-arrival gaps and drawn
    destinations, in draw order (``dst=None`` records a consumed draw
    that emitted no packet — fixed-point sources — so the time fold
    stays identical to the one-shot generator).  ``trace_at`` applies an
    injection rate by folding ``t += gap / rate`` exactly like
    :func:`synthetic_trace`, so sweeping the rate replays the *same*
    packet population under tighter spacing — the compile-once sweeps
    recompute only these start offsets per point.
    """

    cols: int
    rows: int
    nbytes: int
    draws: tuple  # per node: tuple of (unit gap, dst Coord | None)

    def starts_at(self, rate: float) -> list[float]:
        """Injection starts of the emitted packets at ``rate``, in event
        order (exact float fold of the unit gaps)."""
        out = []
        for node_draws in self.draws:
            t = 0.0
            for gap, pair in node_draws:
                t += gap / rate
                if pair is not None:
                    out.append(t)
        return out

    def trace_at(self, rate: float) -> Trace:
        trace = Trace(self.cols, self.rows)
        for node_draws in self.draws:
            t = 0.0
            for gap, pair in node_draws:
                t += gap / rate
                if pair is None:
                    continue
                src, dst = pair
                trace.events.append(
                    TrafficEvent(
                        "unicast", start=t, nbytes=self.nbytes,
                        src=tuple(src), dst=tuple(dst),
                    )
                )
        return trace


def synthetic_population(mesh: Mesh2D, cfg: SyntheticConfig) -> SyntheticPopulation:
    """Draw the seeded packet population once (gaps + destinations); the
    injection rate is applied later by :meth:`SyntheticPopulation.trace_at`.
    Consumes the PRNG exactly like :func:`synthetic_trace`."""
    rng = random.Random(cfg.seed)
    draws = []
    if cfg.pattern == "all_to_all":
        for src in mesh.coords():
            node = []
            for dst in mesh.coords():
                if dst == src:
                    continue
                node.append((rng.expovariate(1.0), (src, dst)))
            draws.append(tuple(node))
    else:
        for src in mesh.coords():
            node = []
            for _ in range(cfg.packets_per_node):
                gap = rng.expovariate(1.0)
                dst = _destination(mesh, cfg, src, rng)
                node.append((gap, None if dst is None else (src, dst)))
            draws.append(tuple(node))
    return SyntheticPopulation(
        cols=mesh.cols, rows=mesh.rows, nbytes=cfg.nbytes, draws=tuple(draws)
    )


def synthetic_trace(mesh: Mesh2D, cfg: SyntheticConfig) -> Trace:
    """Generate one single-phase synthetic workload trace."""
    return synthetic_population(mesh, cfg).trace_at(cfg.rate)


# ---------------------------------------------------------------------------
# Collective storms: the paper's SUMMA / FCL phase structure as traffic.
# Mesh extents must be powers of two — the (dst, mask) submesh-encoding
# constraint (Section 3.2.2) that the row/column multicasts rely on.
# ---------------------------------------------------------------------------


def _check_storm_mesh(mesh: Mesh2D) -> None:
    from repro_torch.core.topology import is_pow2

    if not (is_pow2(mesh.cols) and is_pow2(mesh.rows)):
        raise ValueError(
            f"collective storms need power-of-two mesh extents for (dst, mask)"
            f" row/column addressing, got {mesh.cols}x{mesh.rows}"
        )


def _stagger(trace: Trace, interval: float) -> Trace:
    """Offset each phase's non-barrier events by ``interval`` in order."""
    if interval == 0.0:
        return trace
    counts: dict[int, int] = {}
    out = Trace(trace.cols, trace.rows)
    for ev in trace.events:
        if ev.kind != "barrier":
            i = counts.get(ev.phase, 0)
            counts[ev.phase] = i + 1
            ev = dataclasses.replace(ev, start=ev.start + i * interval)
        out.events.append(ev)
    return out


def _row_multicast_ops(b, mesh, k, tile_bytes, phase, t0, interval):
    """SUMMA iteration ``k``: the column-``k`` tile of every row multicasts
    its A block along the row.  Returns (op ids, next start offset)."""
    out, t = [], t0
    for y in range(mesh.rows):
        ma = Submesh(0, y, mesh.cols, 1).multi_address()
        out.append(b.multicast((k % mesh.cols, y), ma, tile_bytes,
                               start=t, phase=phase))
        t += interval
    return out, t


def _col_reduction_ops(b, mesh, tile_bytes, phase, t0, interval):
    """FCL: every column reduces its partial C tiles into its row-0 tile."""
    out, t = [], t0
    for x in range(mesh.cols):
        out.append(b.reduction([(x, y) for y in range(mesh.rows)], (x, 0),
                               tile_bytes, start=t, phase=phase))
        t += interval
    return out, t


def summa_storm(
    mesh: Mesh2D,
    tile_bytes: int = 2048,
    iters: int | None = None,
    interval: float = 0.0,
) -> Trace:
    """SUMMA iteration traffic: concurrent row A- and column B-multicasts.

    Iteration ``k`` (one phase): the tile in column ``k`` of every row
    multicasts its A block along the row, and the tile in row ``k`` of
    every column multicasts its B block along the column, all sharing the
    fabric; a hardware barrier closes the phase.  ``interval`` staggers
    stream starts within a phase (0 = the full concurrent storm).

    The events are exactly the native-schedule cost path of
    ``summa.summa_program`` (one generator, no drift); this wrapper adds
    the mesh validation, the flat-trace flattening and the injection
    stagger.
    """
    _check_storm_mesh(mesh)
    from repro_torch.core.summa import summa_program

    return _stagger(
        summa_program(mesh, tile_bytes, schedule="native",
                      iters=iters).to_trace(),
        interval,
    )


def fcl_storm(
    mesh: Mesh2D,
    tile_bytes: int = 2048,
    phases: int = 1,
    interval: float = 0.0,
) -> Trace:
    """FCL partial-C reduction traffic: concurrent per-column reductions.

    Each phase reduces every column's partial C tiles into the row-0 tile
    of the column (one wide in-network reduction per column, all columns
    concurrently), then barriers.
    """
    _check_storm_mesh(mesh)
    from repro_torch.core.noc.program import ProgramBuilder

    b = ProgramBuilder(mesh)
    for ph in range(phases):
        ids, _ = _col_reduction_ops(b, mesh, tile_bytes, ph, 0.0, interval)
        b.barrier(phase=ph, deps=ids)
    return b.build().to_trace()


def mixed_storm(
    mesh: Mesh2D,
    tile_bytes: int = 1024,
    unicast_bytes: int = 256,
    unicasts_per_node: int = 2,
    rate: float = 0.05,
    phases: int = 1,
    seed: int = 0,
) -> Trace:
    """Mixed-class storm: per-column reductions + uniform unicast background.

    Every phase injects the FCL column reductions (each column's tiles
    reduce into its row-0 tile — pure column-link traffic under the
    XY-mirror join) *concurrently* with a seeded uniform-random unicast
    background whose XY tails also cross those columns, then barriers.
    This is the head-of-line blocking scenario virtual channels exist
    for: with ``num_vcs=1`` the unicast and reduction classes contend
    beat-by-beat on shared column links; with ``num_vcs>=2`` the default
    class map separates them and the storm completes strictly earlier
    (asserted in tests and gated in ``benchmarks.bench_routing``).

    The background is the standard seedable uniform generator
    (:func:`synthetic_trace`, reseeded per phase), not a private
    injection loop, so the two share one injection model.
    """
    _check_storm_mesh(mesh)
    from repro_torch.core.noc.program import ProgramBuilder

    b = ProgramBuilder(mesh)
    for ph in range(phases):
        ids, _ = _col_reduction_ops(b, mesh, tile_bytes, ph, 0.0, 0.0)
        background = synthetic_trace(mesh, SyntheticConfig(
            pattern="uniform", rate=rate, nbytes=unicast_bytes,
            packets_per_node=unicasts_per_node, seed=seed + ph,
        ))
        ids += [
            b.unicast(e.src, e.dst, e.nbytes, start=e.start, phase=ph)
            for e in background.events
        ]
        b.barrier(phase=ph, deps=ids)
    return b.build().to_trace()


def collective_storm(
    mesh: Mesh2D,
    tile_bytes: int = 2048,
    phases: int | None = None,
    interval: float = 0.0,
) -> Trace:
    """Combined storm: SUMMA row-multicasts + FCL column-reductions.

    Phase ``k`` injects the row A-multicasts of SUMMA iteration ``k``
    *and* a per-column partial-C reduction, then barriers — the heaviest
    mixed collective load the paper's workloads generate concurrently.
    """
    _check_storm_mesh(mesh)
    from repro_torch.core.noc.program import ProgramBuilder

    phases = mesh.cols if phases is None else phases
    b = ProgramBuilder(mesh)
    for k in range(phases):
        ids, t = _row_multicast_ops(b, mesh, k, tile_bytes, k, 0.0, interval)
        more, _ = _col_reduction_ops(b, mesh, tile_bytes, k, t, interval)
        b.barrier(phase=k, deps=ids + more)
    return b.build().to_trace()
