"""Fluent construction of collective programs.

A :class:`ProgramBuilder` appends typed ops to a growing
:class:`~repro_torch.core.noc.program.ops.Program` and returns their ids, so
dependency edges are written the way dataflow is thought about::

    b = ProgramBuilder(Mesh2D(4, 4))
    red = b.reduction([(x, 0) for x in range(4)], (0, 0), 4096)
    mc = b.multicast((0, 0), row_maddr, 4096, deps=[red])
    c = b.compute((3, 0), cycles=512.0, deps=[mc])
    prog = b.build()

``deps`` accepts ids (or iterables of ids) returned by earlier calls.
Every method also takes ``start`` (injection offset in cycles after the
op's release) and ``phase`` (defaults to the builder's current phase;
:meth:`barrier` advances it, mirroring how a ``TraceRecorder`` closes
phases) — the metadata the legacy barrier/window execution modes and the
``Trace`` round trip are built on.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from repro_torch.core.noc.program.ops import (
    BarrierOp,
    ComputeOp,
    MulticastOp,
    Op,
    Program,
    ReductionOp,
    UnicastOp,
    _xy,
)
from repro_torch.core.topology import Mesh2D, MultiAddress


def _dep_ids(deps) -> tuple[int, ...]:
    """Normalize ``deps``: an id, or any (nested) iterable of ids."""
    if deps is None:
        return ()
    if isinstance(deps, int):
        return (deps,)
    out: list[int] = []
    for d in deps:
        for i in _dep_ids(d):
            if i not in out:
                out.append(i)
    return tuple(out)


class ProgramBuilder:
    """Accumulates ops into a :class:`Program` over one mesh.

    ``params`` is only consulted to convert ``compute(flops=...)`` into
    cycles; it is *not* stamped on the program (pass ``routing`` /
    ``num_vcs`` / ``vc_select`` / ``vc_map`` explicitly to stamp a
    router configuration, as a ``TraceRecorder`` would).
    """

    def __init__(self, mesh: Mesh2D, params=None, *, routing=None,
                 num_vcs=None, vc_select=None, vc_map=None):
        self.mesh = mesh
        self.params = params
        self.phase = 0
        self._ops: list[Op] = []
        self._stamps = dict(routing=routing, num_vcs=num_vcs,
                            vc_select=vc_select, vc_map=vc_map)

    # -- core ---------------------------------------------------------------

    def _push(self, op: Op) -> int:
        self._ops.append(op)
        return op.id

    def _head(self, deps, start: float, phase: Optional[int]) -> dict:
        return dict(
            id=len(self._ops),
            deps=_dep_ids(deps),
            start=float(start),
            phase=self.phase if phase is None else int(phase),
        )

    # -- op constructors ----------------------------------------------------

    def unicast(self, src, dst, nbytes: int, *, deps=None, start: float = 0.0,
                phase: Optional[int] = None) -> int:
        return self._push(UnicastOp(
            src=_xy(src), dst=_xy(dst), nbytes=int(nbytes),
            **self._head(deps, start, phase)))

    def multicast(self, src, maddr: MultiAddress, nbytes: int, *, deps=None,
                  start: float = 0.0, phase: Optional[int] = None) -> int:
        return self._push(MulticastOp(
            src=_xy(src), dst=_xy(maddr.dst), x_mask=maddr.x_mask,
            y_mask=maddr.y_mask, nbytes=int(nbytes),
            **self._head(deps, start, phase)))

    def reduction(self, sources: Sequence, dst, nbytes: int, *, deps=None,
                  start: float = 0.0, phase: Optional[int] = None) -> int:
        return self._push(ReductionOp(
            sources=tuple(_xy(s) for s in sources), dst=_xy(dst),
            nbytes=int(nbytes), **self._head(deps, start, phase)))

    def compute(self, tile, cycles: float | None = None, *,
                flops: float | None = None, deps=None, start: float = 0.0,
                phase: Optional[int] = None) -> int:
        """A compute interval on ``tile``.

        Give either ``cycles`` directly, or ``flops`` to derive cycles
        from the builder's params the way ``model.py`` costs GEMM tiles:
        ``cycles = (flops / 2) / (gemm_utilization * macs_per_cycle)``
        (one MAC = 2 flops).
        """
        if (cycles is None) == (flops is None):
            raise ValueError("compute() needs exactly one of cycles=/flops=")
        if cycles is None:
            p = self.params
            if p is None:
                from repro_torch.core.noc.params import NoCParams

                p = NoCParams()
            cycles = (flops / 2.0) / (p.gemm_utilization * p.macs_per_cycle)
        return self._push(ComputeOp(
            tile=_xy(tile), cycles=float(cycles),
            **self._head(deps, start, phase)))

    def barrier(self, participants: Iterable | None = None, counter=(0, 0),
                *, flavor: str = "", deps=None, start: float = 0.0,
                phase: Optional[int] = None) -> int:
        """Barrier over ``participants`` (default: the whole mesh); closes
        the builder's current phase (subsequent ops land in the next one
        unless they pass ``phase=`` explicitly)."""
        if participants is None:
            participants = self.mesh.coords()
        op_id = self._push(BarrierOp(
            participants=tuple(_xy(c) for c in participants),
            counter=_xy(counter), flavor=flavor,
            **self._head(deps, start, phase)))
        self.phase = self._ops[-1].phase + 1
        return op_id

    # -- finalize -----------------------------------------------------------

    def build(self) -> Program:
        return Program(
            self.mesh.cols, self.mesh.rows, list(self._ops), **self._stamps
        ).validate()
