"""Cycle-level substrate reproducing the paper's own evaluation.

The copy of ``repro.core.noc`` in this package lacks ``shard``,
``resilience``, ``telemetry`` and ``service``, which are not ported yet
(ROADMAP.md, queue 1 item 2): ``NoCSim.run(engine='shard')`` and
``fingerprint.store_schema_doc`` raise ``NotImplementedError``.

``params``    — hardware/runtime parameter sets (+ TPU-pod mapping)
``model``     — the paper's analytical runtime models, Eqs (1)-(6), (10)-(15)
``netsim``    — flit-level 2-D-mesh simulator (multicast fork / reduction
                join); streams keep exact Fraction beat arithmetic and
                expose both per-call (``requests``) and incremental
                (``ready_units``/``advance_unit``) readiness; routes and
                collective trees come from the configured routing policy,
                and every stream carries the virtual channel of its
                traffic class
``routing``   — router microarchitecture subsystem:
                ``routing.policies``  pluggable deterministic minimal
                                      routing — ``xy`` (reference),
                                      ``yx``, ``o1turn`` (cycle-balanced
                                      XY/YX split), ``oddeven`` (Chiu's
                                      turn model, deterministic
                                      load-spreading selection);
                                      ``NoCParams.routing`` selects
                ``routing.turns``     exact channel-dependency-graph
                                      deadlock-freedom checks per route
                                      class (O1TURN needs a VC per class)
                ``routing.trees``     policy-generic multicast fork /
                                      reduction join tree builders,
                                      bit-identical to the legacy XY
                                      builders for ``xy``, memoized on
                                      (policy, mesh, addresses)
``engine``    — bit-identical run loops: ``heap`` (default; global
                min-heap keyed on exact next-ready cycle, lazy
                invalidation, Fenwick-tracked round-robin positions,
                incremental per-unit readiness), ``event`` (idle-gap
                fast-forward, O(streams) per active cycle) and ``cycle``
                (the per-cycle reference loop).  Identical per-stream
                arrivals, completion cycles and arbitration counter
                across all engines; all arbitrate one beat per
                (link, VC) per cycle (``NoCParams.num_vcs``, ``vc_map``
                / ``vc_select``), which degenerates to the historical
                whole-link arbitration at ``num_vcs=1``.
                ``NoCSim.run(profile=True)`` returns an
                :class:`~repro_torch.core.noc.engine.EngineProfile` of
                scheduler counters (heap pushes/pops, lazy
                invalidations, shard epochs/boundary reconciliations).
``shard``     — ``engine='shard'`` (or ``'shard:GXxGY:W'``): the
                region-sharded replay engine for 128x128-class meshes.
                Invariants that make it exact: every unit's links share
                a source tile, so links partition by rectangular region
                (no cross-region arbitration); the round-robin order
                restricted to a region is the global order (same
                rotated live-position key); and conservatively bounded
                epochs (T = 1 + min over permanently valid lower bounds
                on boundary-unit fires and stream completions, lazily
                refreshed) freeze the live set and all cross-region
                arrivals, so per-(link, VC) arbitration runs
                independently per region — serially or on fork-worker
                processes — and reconciles boundary links at epoch
                edges.  Bit-identical to ``heap`` (arrivals, done
                cycles, ``_rr``) for every grid and worker count;
                falls back to in-process execution (with a warning)
                when workers cannot spawn.
``program``   — collective program IR, the single workload API from
                emitters to engines:
                ``program.ops``      typed op nodes (unicast / multicast /
                                     reduction / barrier / compute) with
                                     explicit dependency edges; ``Program``
                                     (trace schema v3 serialization, v1/v2
                                     loading via phase→barrier-dep
                                     conversion, lossless Trace round trip,
                                     comm/compute filters)
                ``program.builder``  fluent ``ProgramBuilder`` — the target
                                     of every emitter (``schedules``,
                                     ``summa``, ``overlap``, storms)
                ``program.lower``    one lowering pass to engine streams;
                                     ``run_program`` executes per-op
                                     dependency gating (``mode='op'``,
                                     comm/compute overlap via ComputeOp
                                     timed streams), the legacy
                                     phase-serialized semantics
                                     (``mode='barrier'``) or sliding-window
                                     overlap (``mode='window'``, endpoint
                                     tiles or policy-aware link footprints);
                                     per-op completion/latency results with
                                     percentile stats.  ``CompiledWorkload``
                                     / ``compile_workload``: lower a
                                     (mesh, params, program) once — routes,
                                     fork/join trees, stream specs, unit
                                     topologies, packet ids — and re-run it
                                     with only injection starts swapped
                                     (cache key: one spec per op of the
                                     compiled program instance)
``traffic``   — traffic engine subsystem:
                ``traffic.patterns``  seedable synthetic workloads (uniform,
                                      transpose, bit-complement, bit-reversal,
                                      hotspot, neighbor, all-to-all) and
                                      SUMMA/FCL collective storms; the
                                      rate-independent draws live in a
                                      ``SyntheticPopulation`` so sweeps
                                      re-time one population per rate
                ``traffic.trace``     TrafficEvent/Trace serialization, live
                                      TraceRecorder capture, and contended
                                      replay — a thin shim over the program
                                      IR (phase→barrier-dep conversion +
                                      ``run_program``), bit-identical to the
                                      historical phase-barrier and
                                      sliding-window modes; loads schema
                                      v1/v2/v3 files
                ``traffic.sweep``     injection-rate vs. latency/throughput
                                      saturation curves with p50/p95/p99
                                      latency tails; ``workers=N`` fans
                                      point chunks over a process pool
                                      (warning on fallback) and
                                      ``compile_once`` lowers each
                                      population one time per worker via
                                      ``CompiledWorkload``;
                                      ``compare_policies`` reports the
                                      saturation-point shift per
                                      (routing policy, VC count)
``faults``    — fault-injection subsystem (degraded-mesh execution):
                ``faults.model``    seedable ``FaultSet`` (dead links,
                                    dead routers, flaky links with
                                    duty-cycle retry cost as exact
                                    per-edge Fraction rates, CRC-32
                                    jitter); serializes into the
                                    trace/program stamp for
                                    bit-identical replay;
                                    ``NoCParams.faults`` hooks it into
                                    every engine at stream-construction
                                    time (the zero-fault path is
                                    untouched); ``surviving_submesh`` /
                                    ``degrade_program`` are the fabric
                                    mirror of ``runtime/elastic.py``
                ``faults.repair``   detour routing around dead elements
                                    on the odd-even turn model with a
                                    dedicated escape VC when
                                    ``num_vcs`` affords one, structural
                                    O(nodes) min-VC bounds
                                    (``fast_min_vcs``) agreeing with
                                    the exact enumeration, and the
                                    exact per-VC channel-dependency
                                    gate (``verify_route_deps``) every
                                    degraded run passes before
                                    executing
                ``faults.regraft``  multicast fork / reduction join
                                    trees rebuilt around faulted nodes
                                    (deepest / first-intersection
                                    grafting) with out-tree/in-tree
                                    validity checkers
``resilience`` — resilient execution layer (failures during a run, where
                ``faults`` models failures known before it):
                ``resilience.checkpoint`` deterministic snapshot/restore
                                    of a paused run at an exact cycle
                                    boundary — versioned, sha256-
                                    fingerprinted JSON; ``restore()`` +
                                    ``run(start_cycle=C)`` is
                                    bit-identical to the uninterrupted
                                    run on every engine
                ``resilience.supervise`` process-supervision primitives
                                    for the shard fork backend:
                                    poll-with-deadline receives,
                                    heartbeats, dead/wedged detection,
                                    respawn budgets and terminate→kill
                                    teardown escalation; the shard
                                    engine respawns-and-replays a lost
                                    worker from its epoch op log, or
                                    degrades to in-process execution,
                                    without changing results
                ``resilience.timeline`` seedable ``FaultTimeline`` of
                                    mid-run ``(cycle, FaultSet)``
                                    events: run to the event cycle,
                                    compose fault sets, re-lower the
                                    affected survivors through the
                                    ``faults`` detour/re-graft/escape-VC
                                    machinery (CDG gate re-verified),
                                    resume; an empty timeline is
                                    bit-identical to a plain run
``telemetry`` — opt-in fabric observability (zero overhead when off —
                ``run(telemetry=None)`` is the exact committed-baseline
                code path):
                ``telemetry.collector`` ``Collector`` attaches via
                                    ``NoCSim.run(telemetry=...)`` and
                                    accumulates per-(link, VC) busy-beat
                                    and retry counters plus per-tile
                                    inject/eject totals at beat-advance
                                    granularity — identical totals on
                                    every engine by construction (the
                                    heap/shard engines batch per-unit
                                    fire counts and fold at run exit /
                                    epoch reply); fault events annotate,
                                    program runs record per-op spans;
                                    windowed timeseries (live streams,
                                    offered vs delivered bandwidth,
                                    per-region occupancy) and stream
                                    lifecycle spans derive lazily from
                                    the attached sim; checkpoints carry
                                    collector state bit-exactly
                ``telemetry.stats`` ``FabricStats`` read-out: heatmap
                                    grids, top-k hot-link tables, ASCII
                                    rendering
                ``telemetry.perfetto`` Chrome/Perfetto ``trace_event``
                                    JSON export (comm/compute/stream/
                                    fault lanes + counter tracks) for
                                    ``ui.perfetto.dev``
``service``   — simulation-as-a-service: a persistent local evaluation
                server over the direct APIs:
                ``service.jobs``    declarative job documents (sweep /
                                    policy-compare / run-program) with
                                    canonical fingerprints and the
                                    single ``execute_workload`` path
                                    every result goes through
                ``service.cache``   compiled-workload LRU + completed-
                                    point result memo keyed on the
                                    shared ``noc.fingerprint`` keys,
                                    with exact hit/miss/eviction
                                    accounting
                ``service.scheduler`` slot-based dispatch over
                                    persistent supervised fork workers
                                    (per-client fairness, in-flight
                                    point coalescing, kill/wedge
                                    recovery with chunk retry,
                                    degradation to in-process, bounded
                                    admission with retry-after,
                                    graceful drain)
                ``service.store``   crash-safe on-disk result store:
                                    append-only torn-write-tolerant
                                    JSONL memo, hydrated at server
                                    start — restart (even ``kill -9``)
                                    survival with zero recompute
                ``service.server`` / ``service.client``  JSONL protocol
                                    over AF_UNIX and token-
                                    authenticated TCP: concurrent
                                    clients, streamed result rows,
                                    cancellation, SIGTERM drain, client
                                    reconnect/backoff with idempotent
                                    resubmission; rows are
                                    bit-identical to calling
                                    ``saturation_sweep`` /
                                    ``run_program`` directly, across
                                    server restarts
``fingerprint`` — the one canonical sha256 module behind every
                content-addressed key (sweep-journal keys, checkpoint
                fingerprints, service workload/point identities), with
                the historical byte forms preserved exactly
``energy``    — Table-1 energy model and Fig-10 scaling
``calibrate`` — validation of every numeric claim in the paper, plus
                ``load_claims``: saturation-aware checks of a sweep
                curve at a chosen offered load (not just idle-network),
                and ``fit_claims``: least-squares *recovery* of
                alpha0/beta from the linear region of measured sweep
                curves across payload sizes (round-trip tested against
                synthetic curves)
"""

from repro_torch.core.noc.params import NoCParams, PAPER_MICRO, PAPER_GEMM  # noqa: F401
