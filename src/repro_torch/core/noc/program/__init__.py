"""Collective Program IR: one declarative workload API from emitters to
engines.

``ops``     — the IR: typed op nodes (``UnicastOp`` / ``MulticastOp`` /
              ``ReductionOp`` / ``BarrierOp`` / ``ComputeOp``) with
              explicit dependency edges, the :class:`Program` container
              (trace schema v3 serialization, v1/v2 loading via the
              phase→barrier-dep conversion, lossless ``Trace``
              round trip, comm/compute filters)
``builder`` — :class:`ProgramBuilder`, the fluent construction API every
              emitter (``schedules``, ``summa``, ``overlap``, the
              ``patterns`` storms) now targets
``lower``   — the single lowering pass from programs to engine streams:
              :func:`run_program` with per-op dependency gating
              (``mode='op'``), the legacy phase-serialized semantics
              (``mode='barrier'``) and sliding-window overlap
              (``mode='window'``, tile- or policy-aware link
              footprints); per-op completion/latency results
"""

from repro_torch.core.noc.program.builder import ProgramBuilder  # noqa: F401
from repro_torch.core.noc.program.lower import (  # noqa: F401
    CompiledWorkload,
    OpRun,
    ProgramResult,
    compile_workload,
    run_program,
)
from repro_torch.core.noc.program.ops import (  # noqa: F401
    COMM_KINDS,
    PROGRAM_VERSION,
    BarrierOp,
    ComputeOp,
    MulticastOp,
    Op,
    Program,
    ReductionOp,
    UnicastOp,
    from_trace,
)
