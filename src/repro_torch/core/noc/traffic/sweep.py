"""Injection-rate saturation sweeps: offered load vs. latency/throughput.

The standard NoC evaluation methodology (cf. Guirado et al., Tiwari et
al. in PAPERS.md): inject a synthetic pattern at increasing rates and
report the latency curve up to and past saturation.  Feasible only with
the fast engines — a 16x16 mesh at low injection rates is >95% idle
cycles under the per-cycle loop; the heap engine plus the ``workers=N``
process-pool fan-out makes even 64x64 curves a seconds-scale run.

Because :func:`~.patterns.synthetic_trace` draws destinations and
unit-rate gaps once per seed and only rescales gaps with the rate, every
point of a sweep replays the *same* packet population under tighter
spacing, so mean latency is monotone in offered load by construction of
the workload (verified in tests) and the curves are smooth even with few
packets per node.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Optional, Sequence

from repro_torch.core.noc.params import NoCParams
from repro_torch.core.topology import Mesh2D
from repro_torch.core.noc.traffic.patterns import (
    SyntheticConfig,
    SyntheticPopulation,
    synthetic_population,
    synthetic_trace,
)
from repro_torch.core.noc.traffic.trace import ReplayResult, replay


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    rate: float               # offered load [packets / node / cycle]
    packets: int              # packets actually injected
    mean_latency: float       # inject -> last-beat-delivered [cycles]
    max_latency: float
    makespan: int             # cycle the last stream completed
    throughput: float         # delivered [beats / node / cycle]
    # Latency percentiles (nearest-rank, see StreamStats): the knee of a
    # saturation curve shows up in the tail long before the mean moves,
    # and a hotspotted victim stream is invisible in mean/max alone.
    p50_latency: float = 0.0
    p95_latency: float = 0.0
    p99_latency: float = 0.0

    def csv(self) -> str:
        return (
            f"{self.rate:g},{self.packets},{self.mean_latency:.1f},"
            f"{self.max_latency:.1f},{self.makespan},{self.throughput:.4f},"
            f"{self.p50_latency:.1f},{self.p95_latency:.1f},"
            f"{self.p99_latency:.1f}"
        )


CSV_HEADER = (
    "rate,packets,mean_latency,max_latency,makespan,throughput,"
    "p50_latency,p95_latency,p99_latency"
)


def _aggregate_point(mesh, cfg, res: ReplayResult, p: NoCParams) -> SweepPoint:
    beats = sum(p.beats(s.event.nbytes) for s in res.streams)
    makespan = max(res.makespan, 1)
    stats = res.stats()
    return SweepPoint(
        rate=cfg.rate,
        packets=len(res.streams),
        mean_latency=stats.mean,
        max_latency=stats.max,
        makespan=res.makespan,
        throughput=beats / (makespan * mesh.num_tiles),
        p50_latency=stats.p50,
        p95_latency=stats.p95,
        p99_latency=stats.p99,
    )


def measure(
    mesh: Mesh2D,
    cfg: SyntheticConfig,
    params: NoCParams | None = None,
    engine: str = "heap",
    compiled=None,
    population: Optional[SyntheticPopulation] = None,
) -> SweepPoint:
    """Replay one synthetic workload and aggregate its stream metrics.

    With ``compiled`` (a :class:`~repro_torch.core.noc.program.CompiledWorkload`
    of this population's trace) and ``population``, only the injection
    starts are recomputed for ``cfg.rate`` — routes, fork/join trees and
    compiled unit records are reused.  Bit-identical to the uncompiled
    path.
    """
    p = params or NoCParams()
    if compiled is None or population is None:
        trace = synthetic_trace(mesh, cfg)
        res: ReplayResult = replay(trace, params=p, engine=engine)
    else:
        from repro_torch.core.noc.traffic.trace import result_to_replay

        starts = population.starts_at(cfg.rate)
        pres = compiled.run(engine=engine,
                            start_of=lambda op: starts[op.id])
        res = result_to_replay(pres)
    return _aggregate_point(mesh, cfg, res, p)


def _maybe_chaos(cfgs) -> None:
    """Test hook: ``REPRO_SWEEP_CHAOS=<rate>:<times>:<counter-path>``
    makes the first ``times`` chunk executions that contain ``rate`` fail.
    An on-disk counter is the only channel that survives the process
    boundary — monkeypatching cannot reach pool workers."""
    spec = os.environ.get("REPRO_SWEEP_CHAOS")
    if not spec:
        return
    rate_s, times_s, path = spec.split(":", 2)
    if not any(abs(c.rate - float(rate_s)) < 1e-12 for c in cfgs):
        return
    n = 0
    if os.path.exists(path):
        with open(path) as f:
            n = len(f.read().splitlines())
    if n < int(times_s):
        with open(path, "a") as f:
            f.write("fail\n")
        raise RuntimeError(
            f"sweep chaos: injected chunk failure #{n + 1} at rate {rate_s}")


def _sweep_chunk(args: tuple) -> list[SweepPoint]:
    """Top-level process-pool entry point (must be picklable): one chunk
    of sweep points, sharing a single compiled workload.  Each worker
    compiles its population once and amortizes the lowering over every
    rate in its chunk (the compile-once path)."""
    mesh, cfgs, params, engine, compile_once = args
    if not cfgs:
        return []
    _maybe_chaos(cfgs)
    if not compile_once:
        return [measure(mesh, cfg, params=params, engine=engine)
                for cfg in cfgs]
    from repro_torch.core.noc.program import compile_workload, from_trace

    pop = synthetic_population(mesh, cfgs[0])
    compiled = compile_workload(from_trace(pop.trace_at(cfgs[0].rate)),
                                params=params)
    return [
        measure(mesh, cfg, params=params, engine=engine,
                compiled=compiled, population=pop)
        for cfg in cfgs
    ]


JOURNAL_KIND = "repro-sweep-journal"
JOURNAL_VERSION = 1

# Human-readable label per sweep-key component (the order diagnostics
# list them in).
_KEY_COMPONENTS = (
    ("mesh", "mesh"),
    ("params", "params"),
    ("engine", "engine"),
    ("compile_once", "compile_once"),
    ("cfgs", "config list (pattern/rates/seed/payload)"),
)


def _journal_key(mesh, cfgs, params, engine, compile_once) -> str:
    """Identity of one sweep invocation: sha256 over everything that
    changes its results.  A journal written under a different key must
    not be resumed from — mixed points would be silent garbage.
    (Delegates to the shared canonical-fingerprint module; the key bytes
    are unchanged, so committed journals stay resumable.)"""
    from repro_torch.core.noc.fingerprint import sweep_key

    return sweep_key(mesh, cfgs, params, engine, compile_once)


def _mismatch_detail(header: dict, parts: Optional[dict]) -> str:
    """Name which component(s) of the sweep key differ from the journal
    header, when the header carries per-component digests (journals
    written before those were recorded fall back to the bare hashes)."""
    theirs = header.get("parts")
    if not isinstance(theirs, dict) or parts is None:
        return ("the journal header predates per-component digests, so "
                "the differing component cannot be named")
    differing = [label for comp, label in _KEY_COMPONENTS
                 if theirs.get(comp) != parts.get(comp)]
    if not differing:
        return "per-component digests unexpectedly agree"
    return "differing component(s): " + ", ".join(differing)


def _journal_load(path: str, key: str,
                  parts: Optional[dict] = None) -> dict[float, SweepPoint]:
    """Completed points of a resumable journal (empty if none).  Raises
    ``ValueError`` on a key mismatch — naming the differing key
    component when the header allows it; a truncated trailing line
    (crash mid-append) is ignored."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        return {}
    header = json.loads(lines[0])
    if header.get("kind") != JOURNAL_KIND:
        raise ValueError(f"{path} is not a {JOURNAL_KIND} file")
    if header.get("key") != key:
        raise ValueError(
            f"sweep journal {path} was written by a different sweep "
            f"configuration (key {header.get('key', '')[:16]}... vs "
            f"{key[:16]}...; {_mismatch_detail(header, parts)}); "
            f"delete it or pass a different journal path")
    out: dict[float, SweepPoint] = {}
    for line in lines[1:]:
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            break  # torn final append from an interrupted run
        pt = SweepPoint(**d["point"])
        out[pt.rate] = pt
    return out


def _journal_append(path: str, pt: SweepPoint) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"rate": pt.rate,
                            "point": dataclasses.asdict(pt)}) + "\n")
        f.flush()


def saturation_sweep(
    mesh: Mesh2D,
    pattern: str,
    rates: Sequence[float],
    nbytes: int = 256,
    packets_per_node: int = 4,
    seed: int = 0,
    params: NoCParams | None = None,
    engine: str = "heap",
    workers: int | None = None,
    compile_once: bool = True,
    max_chunk_retries: int = 2,
    retry_backoff_s: float = 0.5,
    journal: str | None = None,
    **pattern_kw,
) -> list[SweepPoint]:
    """Latency/throughput curve over ``rates`` for one pattern + seed.

    Sweep points are independent replays of the same seeded packet
    population, so ``workers > 1`` fans them out over a process pool
    (chunked to one submission per worker); results come back in rate
    order and are identical to a serial run.  This is what makes 64x64
    curves a seconds-scale operation.  ``compile_once`` (default) lowers
    the population once per worker — routes, trees and compiled unit
    records are cached in a
    :class:`~repro_torch.core.noc.program.CompiledWorkload` and only the
    injection starts change per rate point; results are bit-identical
    either way.

    Failure handling, from least to most severe:

    * A chunk that fails (worker killed, pool broken mid-run) is retried
      — only the failed chunks, in a fresh pool, with capped exponential
      backoff (``retry_backoff_s * 2**attempt``, capped at 8s), up to
      ``max_chunk_retries`` times.  Completed points are never
      recomputed.
    * Chunks still failing after the retry budget run serially, so a
      deterministic error surfaces as itself rather than as a dead pool.
    * A platform that cannot spawn processes at all falls back to serial
      execution with a warning naming the cause.

    ``journal`` names an on-disk JSONL file making the sweep resumable:
    every completed point is appended as it lands, and a rerun of the
    same sweep (same configuration — enforced by a fingerprint key)
    skips the rates already journaled.  Results are identical to an
    uninterrupted run.
    """
    import concurrent.futures

    cfgs = [
        SyntheticConfig(
            pattern=pattern, rate=rate, nbytes=nbytes,
            packets_per_node=packets_per_node, seed=seed, **pattern_kw,
        )
        for rate in rates
    ]
    done: dict[float, SweepPoint] = {}
    if journal is not None:
        from repro_torch.core.noc.fingerprint import sweep_key_parts

        key = _journal_key(mesh, cfgs, params, engine, compile_once)
        parts = sweep_key_parts(mesh, cfgs, params, engine, compile_once)
        done = _journal_load(journal, key, parts)
        if not os.path.exists(journal) or os.path.getsize(journal) == 0:
            with open(journal, "w") as f:
                f.write(json.dumps({"kind": JOURNAL_KIND,
                                    "version": JOURNAL_VERSION,
                                    "key": key,
                                    "parts": parts}) + "\n")
        elif done:
            warnings.warn(
                f"saturation_sweep: resuming from journal {journal} — "
                f"{len(done)} of {len(cfgs)} point(s) already complete",
                RuntimeWarning, stacklevel=2)

    def record(pt: SweepPoint) -> None:
        done[pt.rate] = pt
        if journal is not None:
            _journal_append(journal, pt)

    todo = [c for c in cfgs if c.rate not in done]
    if workers and workers > 1 and len(todo) > 1:
        nproc = min(workers, len(todo))
        size = -(-len(todo) // nproc)
        pending = {i: todo[i:i + size] for i in range(0, len(todo), size)}
        attempt = 0
        pool_ok = True
        while pending and pool_ok and attempt <= max_chunk_retries:
            if attempt:
                time.sleep(min(8.0, retry_backoff_s * 2 ** (attempt - 1)))
            last_exc = None
            try:
                with concurrent.futures.ProcessPoolExecutor(
                        max_workers=min(nproc, len(pending))) as ex:
                    futs = {
                        ex.submit(_sweep_chunk,
                                  (mesh, chunk, params, engine,
                                   compile_once)): i
                        for i, chunk in pending.items()
                    }
                    for fut in concurrent.futures.as_completed(futs):
                        i = futs[fut]
                        try:
                            pts = fut.result()
                        except Exception as exc:
                            last_exc = exc  # chunk stays pending
                            continue
                        for pt in pts:
                            record(pt)
                        del pending[i]
            except (OSError, PermissionError, ImportError,
                    NotImplementedError,
                    concurrent.futures.process.BrokenProcessPool) as exc:
                # sandboxed / fork-less / wasm platform: run serially
                # instead — and say so, naming the cause, because the
                # silent version of this fallback turns "why is my sweep
                # slow" into archaeology.
                warnings.warn(
                    f"saturation_sweep: process pool unavailable "
                    f"({exc!r}); running {len(pending)} chunk(s) "
                    f"serially",
                    RuntimeWarning,
                    stacklevel=2,
                )
                pool_ok = False
                break
            if pending:
                attempt += 1
                if attempt <= max_chunk_retries:
                    backoff = min(8.0, retry_backoff_s * 2 ** (attempt - 1))
                    warnings.warn(
                        f"saturation_sweep: {len(pending)} chunk(s) failed "
                        f"({last_exc!r}); retrying failed chunks only "
                        f"(attempt {attempt}/{max_chunk_retries}) after "
                        f"{backoff:.2g}s backoff",
                        RuntimeWarning,
                        stacklevel=2,
                    )
        # retry budget exhausted (or pool gone): anything left runs
        # serially below, so a deterministic failure raises as itself.
    remaining = [c for c in cfgs if c.rate not in done]
    if remaining:
        for pt in _sweep_chunk((mesh, remaining, params, engine,
                                compile_once)):
            record(pt)
    return [done[c.rate] for c in cfgs]


@dataclasses.dataclass(frozen=True)
class PolicySweep:
    """One (routing policy, VC count) row of a :func:`compare_policies` run."""

    policy: str
    num_vcs: int
    points: tuple[SweepPoint, ...]
    saturation: float              # knee estimate over ``points`` (inf = none)

    def csv(self) -> str:
        sat = "inf" if math.isinf(self.saturation) else f"{self.saturation:g}"
        return f"{self.policy},{self.num_vcs},{sat}"


def compare_policies(
    mesh: Mesh2D,
    pattern: str,
    rates: Sequence[float],
    policies: Sequence[str] = ("xy", "yx", "o1turn", "oddeven"),
    vcs: Sequence[int] = (1,),
    nbytes: int = 256,
    packets_per_node: int = 4,
    seed: int = 0,
    params: NoCParams | None = None,
    engine: str = "heap",
    workers: int | None = None,
    vc_select: str = "packet",
    knee: float = 3.0,
    **pattern_kw,
) -> list[PolicySweep]:
    """Saturation curves for every (policy, VC count) configuration.

    Every configuration replays the *same* seeded packet population
    (destinations and unit-rate gaps are drawn once per seed), so the
    saturation-point shift between rows isolates the routing/channel
    microarchitecture — the axis the hotspot and transpose sweeps are
    designed to expose.  ``vc_select`` defaults to ``"packet"`` because
    synthetic sweeps are single-class (all unicast): packets round-robin
    over the VCs, modeling per-link channel slicing; pass ``"class"``
    when sweeping mixed-class traces.
    """
    base = params or NoCParams()
    out = []
    for policy in policies:
        for num_vcs in vcs:
            p = dataclasses.replace(
                base, routing=policy, num_vcs=num_vcs, vc_select=vc_select
            )
            pts = saturation_sweep(
                mesh, pattern, rates, nbytes=nbytes,
                packets_per_node=packets_per_node, seed=seed, params=p,
                engine=engine, workers=workers, **pattern_kw,
            )
            out.append(PolicySweep(
                policy=policy, num_vcs=num_vcs, points=tuple(pts),
                saturation=saturation_rate(pts, knee=knee),
            ))
    return out


def saturation_shifts(
    results: Sequence[PolicySweep],
    baseline: tuple[str, int] | None = None,
) -> dict[tuple[str, int], float]:
    """Saturation rate of each row relative to the baseline row
    (default: ``("xy", min VC count present)``).  > 1 means the row
    saturates later than XY; ``inf`` means the row never saturated in
    the swept range while the baseline did."""
    if not results:
        return {}
    if baseline is None:
        baseline = ("xy", min(r.num_vcs for r in results))
    by_key = {(r.policy, r.num_vcs): r.saturation for r in results}
    base = by_key.get(baseline)
    if base is None:
        raise ValueError(f"baseline row {baseline} not in results")
    out = {}
    for key, sat in by_key.items():
        if math.isinf(base):
            out[key] = 1.0 if math.isinf(sat) else sat / base
        else:
            out[key] = sat / base
    return out


def saturation_rate(points: Sequence[SweepPoint], knee: float = 3.0) -> float:
    """First offered load whose mean latency exceeds ``knee`` x the
    zero-load latency — a simple saturation-point estimate.  Returns
    ``math.inf`` when the knee is never crossed in the swept range (the
    pattern did not saturate), so it is distinguishable from saturating
    exactly at the last swept rate."""
    if not points:
        return 0.0
    base = points[0].mean_latency
    for pt in points:
        if pt.mean_latency > knee * base:
            return pt.rate
    return math.inf
