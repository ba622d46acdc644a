"""Simulation-as-a-service: a persistent NoC evaluation server.

Design-space exploration hammers the same simulations from many
callers — parameter sweeps share (mesh, params, population) points,
CI jobs re-run yesterday's grids, notebook users iterate on one corner.
This package turns the one-shot ``saturation_sweep`` / ``run_program``
APIs into a long-lived local service that exploits that redundancy:

``jobs``
    Declarative job documents (sweep / policy-compare / run-program)
    with canonical fingerprints, and the single
    :func:`~.jobs.execute_workload` path every result is computed
    through.
``cache``
    The compile-artifact LRU and the completed-point result memo, with
    exact hit/miss/eviction accounting.
``scheduler``
    Slot-based dispatch over persistent supervised fork workers:
    per-client fairness, in-flight point coalescing, worker
    kill/wedge recovery with chunk retry, degradation to in-process.
``store``
    The crash-safe on-disk result store: an append-only,
    torn-write-tolerant JSONL memo of completed points, hydrated into
    the result memo at server start — a restarted (even ``kill -9``'d)
    server serves yesterday's rows as memo hits.
``server`` / ``client``
    A JSONL protocol over ``AF_UNIX`` and (token-authenticated) TCP
    with concurrent clients, streamed result rows, cancellation,
    bounded admission with retry-after overload rejection, graceful
    SIGTERM drain, and client-side reconnection with idempotent
    resubmission (``resume=True``).  :class:`~.server.ServerProcess`
    runs the server as a killable child for chaos/restart testing.

The contract throughout: every row a client receives is bit-identical
to calling the direct API yourself — memoized or freshly computed,
served from disk or fanned out (the service runs the exact compile-once
``measure``/``run_program`` code paths; tests assert equality field by
field, across server restarts).
"""

from repro_torch.core.noc.service.cache import (  # noqa: F401
    CacheStats,
    CompileCache,
    ResultMemo,
)
from repro_torch.core.noc.service.client import (  # noqa: F401
    JobHandle,
    ServiceClient,
    ServiceError,
    ServiceOverloaded,
    ServiceTimeout,
)
from repro_torch.core.noc.service.jobs import (  # noqa: F401
    PolicyCompareJob,
    RunProgramJob,
    SweepJob,
    execute_workload,
    job_from_doc,
)
from repro_torch.core.noc.service.scheduler import (  # noqa: F401
    Scheduler,
    SchedulerOverloaded,
)
from repro_torch.core.noc.service.server import (  # noqa: F401
    ServerProcess,
    SimulationServer,
)
from repro_torch.core.noc.service.store import (  # noqa: F401
    ResultStore,
    StoreMismatch,
)
