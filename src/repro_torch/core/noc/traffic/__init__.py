"""Traffic engine: synthetic workloads, trace capture/replay, sweeps.

``patterns`` — seedable synthetic generators (uniform, transpose,
              bit-complement, bit-reversal, hotspot, neighbor,
              all-to-all), SUMMA/FCL collective storms, and the
              mixed-class unicast+reduction storm (the VC
              head-of-line-blocking scenario)
``trace``    — TrafficEvent/Trace serialization (schema v2: traces carry
              the routing policy / VC count they were captured under; v3
              program files load when flat-expressible), live-sim
              TraceRecorder, and contended replay — a bit-identical shim
              over ``noc/program`` (phase→barrier-dep conversion +
              ``run_program``)
``sweep``    — injection-rate vs. latency/throughput saturation curves
              with p50/p95/p99 latency tails; ``compare_policies``
              sweeps (routing policy, VC count) configurations and
              reports the saturation-point shift

The event-driven engine that makes large-mesh sweeps feasible lives one
level up in ``noc/engine.py``; the program IR that owns workload
description and lowering lives in ``noc/program``; the routing policies
live in ``noc/routing``.  The storm generators build through the
program builder and flatten to traces, so one generation path feeds
both the trace tooling and program execution.
"""

from repro_torch.core.noc.traffic.patterns import (  # noqa: F401
    PATTERNS,
    SyntheticConfig,
    SyntheticPopulation,
    collective_storm,
    fcl_storm,
    mixed_storm,
    summa_storm,
    synthetic_population,
    synthetic_trace,
)
from repro_torch.core.noc.traffic.sweep import (  # noqa: F401
    CSV_HEADER,
    PolicySweep,
    SweepPoint,
    compare_policies,
    measure,
    saturation_rate,
    saturation_shifts,
    saturation_sweep,
)
from repro_torch.core.noc.traffic.trace import (  # noqa: F401
    TRACE_VERSION,
    ReplayResult,
    StreamResult,
    StreamStats,
    Trace,
    TraceRecorder,
    TrafficEvent,
    replay,
)
