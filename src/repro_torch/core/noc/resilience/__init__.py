"""Resilient execution layer: checkpoint/restart, worker supervision,
mid-run fault arrival.  See the package modules:

* ``supervise``  — process supervision primitives (deadlines, heartbeats,
  respawn budgets, teardown escalation) used by the shard fork backend;
* ``checkpoint`` — deterministic snapshot/restore of a paused ``NoCSim``
  run at an exact cycle boundary (versioned, fingerprinted), plus
  ``run_with_autocheckpoint`` for long runs that periodically persist
  and transparently resume;
* ``timeline``   — seedable ``FaultTimeline`` of mid-run fault events,
  applied at checkpoint boundaries via re-lowering.
"""

from repro_torch.core.noc.resilience.checkpoint import (  # noqa: F401
    Snapshot,
    checkpoint,
    restore,
    run_with_autocheckpoint,
)
from repro_torch.core.noc.resilience.supervise import (  # noqa: F401
    Heartbeat,
    SuperviseConfig,
    WorkerDead,
    WorkerFailure,
    WorkerWedged,
    reap,
    supervised_recv,
)
from repro_torch.core.noc.resilience.timeline import (  # noqa: F401
    FaultEvent,
    FaultTimeline,
    apply_fault_event,
    run_with_timeline,
)
