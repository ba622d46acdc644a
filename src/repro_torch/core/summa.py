"""SUMMA GEMM on a 2-D mesh (Section 4.3.1, Fig. 8a).

Port of ``repro.core.summa``.  ``C = A @ B`` with both
operands 2-D block-sharded over mesh axes (row_axis, col_axis): member
(i, j) holds A_ij (M/r, K/c) and B_ij (K/r, N/c).  Per iteration k
(square grid, r == c):

  * member (i, k) *multicasts* its A block along row i   (wide multicast),
  * member (k, j) *multicasts* its B block along col j,
  * every member accumulates C_ij += A_ik @ B_kj: one batched launch of the
    ``gemm`` kernel with ``accumulate=True`` (the DCA epilogue) covers all
    members of the stacked mesh.

``schedule`` selects the multicast implementation: 'native' is the paper's
in-network HW path, 'chain'/'pipelined'/'tree' are the paper's software
baselines (Eqs 1-3).  ``schedule='ring'`` is the beyond-paper Cannon-style
variant: blocks rotate one neighbour per step.

``summa_compute_cycles``, ``summa_program`` and the deprecated
``summa_noc_trace`` are the reference's, verbatim but for their imports:
the SUMMA run as a fabric program for the flit-level simulator.
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as M
from repro_torch.core import schedules as sched
from repro_torch.kernels.ops import gemm
from repro_torch.tracing import spanned


def summa(A_blk, B_blk, row_axis: str, col_axis: str, schedule: str = "native",
          chunks: int = 4):
    """Local SUMMA body; call inside ``with mesh:`` on a square logical grid.

    A_blk: (..., M/r, K/r) — each member's A block (row i, K-block j);
    B_blk: (..., K/r, N/r) — each member's B block (K-block i, col j).
    Returns C_local = (..., M/r, N/r).
    """
    r = M.axis_size(row_axis)
    c = M.axis_size(col_axis)
    if r != c:
        raise ValueError(f"SUMMA requires a square logical grid, got {r}x{c}")
    if schedule == "ring":
        return _summa_ring(A_blk, B_blk, row_axis, col_axis)
    C = A_blk.new_zeros((*A_blk.shape[:-1], B_blk.shape[-1]), dtype=torch.float32)
    for k in range(c):
        a_k = sched.broadcast(A_blk, col_axis, root=k, schedule=schedule, chunks=chunks)
        b_k = sched.broadcast(B_blk, row_axis, root=k, schedule=schedule, chunks=chunks)
        C = gemm(a_k.float().contiguous(), b_k.float().contiguous(), C, accumulate=True)
    return C.to(A_blk.dtype)


def _summa_ring(A_blk, B_blk, row_axis: str, col_axis: str):
    """Cannon-style rotation: neighbour ppermutes only, overlap-friendly.

    Pre-skew so member (i, j) starts with A_{i, i+j} and B_{i+j, j}, then
    rotate A left along rows and B up along columns.
    """
    n = M.axis_size(col_axis)
    i = M.axis_index(row_axis)
    j = M.axis_index(col_axis)
    # skew: A block moves left by i (along col axis), B up by j (along rows)
    a = _rotate_by(A_blk, col_axis, n, shift=i)
    b = _rotate_by(B_blk, row_axis, n, shift=j)
    C = A_blk.new_zeros((*A_blk.shape[:-1], B_blk.shape[-1]), dtype=torch.float32)
    perm = [(p, (p - 1) % n) for p in range(n)]
    for step in range(n):
        C = gemm(a.float().contiguous(), b.float().contiguous(), C, accumulate=True)
        if step + 1 < n:
            a = M.ppermute(a, col_axis, perm)
            b = M.ppermute(b, row_axis, perm)
    return C.to(A_blk.dtype)


@spanned("collective.rotate_by")
def _rotate_by(x, axis: str, n: int, shift):
    """Rotate x left by a per-member shift using log2(n) ppermutes."""
    out = x
    for bit in range(max(1, n.bit_length() - 1)):
        dist = 1 << bit
        perm = [(p, (p - dist) % n) for p in range(n)]
        moved = M.ppermute(out, axis, perm)
        take = ((shift >> bit) & 1).bool()
        out = torch.where(M.lift(take, moved), moved, out)
    return out


def summa_compute_cycles(tile_bytes: int, dtype_bytes: int = 8,
                         params=None) -> float:
    """Per-iteration tile GEMM time for square ``d x d`` blocks.

    ``tile_bytes`` holds ``d^2`` elements of ``dtype_bytes`` each; one
    SUMMA iteration computes a ``d^3`` MAC sub-problem per tile, costed
    exactly like ``model.summa_point``:
    ``d^3 / (gemm_utilization * macs_per_cycle)``.
    """
    import math

    from repro_torch.core.noc.params import NoCParams

    p = params or NoCParams()
    d = math.isqrt(max(1, tile_bytes // dtype_bytes))
    return (d ** 3) / (p.gemm_utilization * p.macs_per_cycle)


def summa_program(mesh, tile_bytes: int, schedule: str = "native",
                  iters: int | None = None, chunks: int = 4, params=None,
                  compute_cycles: float | str | None = None,
                  dtype_bytes: int = 8):
    """The declarative NoC program of a SUMMA run on ``mesh``.

    Without compute (``compute_cycles=None``) this is the pure fabric
    workload, structured exactly like the historical trace: one phase
    per iteration ``k`` — every row's A-block broadcast (root = column
    ``k``) plus every column's B-block broadcast (root = row ``k``)
    share the fabric concurrently, and a hardware barrier closes the
    phase.  ``Program.to_trace()`` of this form is bit-identical to the
    old ``summa_noc_trace`` output.

    With ``compute_cycles`` (a cycle count, or ``"model"`` to derive the
    tile-GEMM time from :func:`summa_compute_cycles`), every tile gains
    a :class:`~repro_torch.core.noc.program.ComputeOp` per iteration and the
    program becomes the **double-buffered** SUMMA pipeline:

    * ``C_k(x, y)`` depends on row-``y``'s A broadcast and column-``x``'s
      B broadcast of iteration ``k``, and on ``C_{k-1}(x, y)`` (the
      accumulator);
    * iteration ``k``'s broadcasts depend on iteration ``k-1``'s (the
      per-axis DMA order) and on the ``C_{k-2}`` tiles of their row /
      column — the two-buffer constraint: comm ``k`` refills the buffer
      compute ``k-2`` read.

    No barrier ops are emitted in this form; phases are stamped ``2k``
    (comm) / ``2k+1`` (compute) so ``run_program(mode='barrier')`` is
    the fully-serialized comm→compute baseline, while ``mode='op'``
    executes the overlap the paper's Section 4.3 scaling rests on.
    """
    from repro_torch.core.noc.program import ProgramBuilder
    from repro_torch.core.topology import Coord

    if mesh.cols != mesh.rows:
        raise ValueError(f"SUMMA requires a square mesh, got {mesh.cols}x{mesh.rows}")
    iters = mesh.cols if iters is None else iters
    if compute_cycles == "model":
        compute_cycles = summa_compute_cycles(tile_bytes, dtype_bytes, params)
    b = ProgramBuilder(mesh)
    # None selects the barrier form; any cycle count (0.0 included — an
    # idealized zero-cost compute still wants the dependency structure)
    # selects the compute-gated pipeline.
    with_compute = compute_cycles is not None
    prev_row: dict[int, list[int]] = {}   # y -> iteration k-1 A-broadcast ops
    prev_col: dict[int, list[int]] = {}
    prev_c: dict[tuple[int, int], int] = {}   # tile -> C_{k-1} op
    prev2_c: dict[tuple[int, int], int] = {}  # tile -> C_{k-2} op
    fence: list[int] = []                 # previous barrier (no-compute form)
    for k in range(iters):
        comm_phase = 2 * k if with_compute else k
        row_ops: dict[int, list[int]] = {}
        col_ops: dict[int, list[int]] = {}
        for y in range(mesh.rows):  # A_{y,k} multicast along row y
            row = [Coord(x, y) for x in range(mesh.cols)]
            deps = [fence, prev_row.get(y, ())]
            deps += [prev2_c[(x, y)] for x in range(mesh.cols)
                     if (x, y) in prev2_c]
            row_ops[y] = sched.broadcast_ops(
                b, row, root=k % mesh.cols, nbytes=tile_bytes,
                schedule=schedule, chunks=chunks, deps=deps,
                phase=comm_phase, params=params)
        for x in range(mesh.cols):  # B_{k,x} multicast along column x
            col = [Coord(x, y) for y in range(mesh.rows)]
            deps = [fence, prev_col.get(x, ())]
            deps += [prev2_c[(x, y)] for y in range(mesh.rows)
                     if (x, y) in prev2_c]
            col_ops[x] = sched.broadcast_ops(
                b, col, root=k % mesh.rows, nbytes=tile_bytes,
                schedule=schedule, chunks=chunks, deps=deps,
                phase=comm_phase, params=params)
        if with_compute:
            prev2_c = prev_c
            cur_c: dict[tuple[int, int], int] = {}
            for x in range(mesh.cols):
                for y in range(mesh.rows):
                    deps = [row_ops[y], col_ops[x]]
                    if (x, y) in prev_c:
                        deps.append(prev_c[(x, y)])
                    cur_c[(x, y)] = b.compute(
                        (x, y), cycles=compute_cycles, deps=deps,
                        phase=comm_phase + 1)
            prev_c = cur_c
        else:
            # Barrier-form: deps mirror the phase fence so mode='op'
            # serializes the same way mode='barrier' does (minus the
            # analytic barrier cost, which the BarrierOp itself carries).
            fence = [b.barrier(
                phase=k,
                deps=[fence, *row_ops.values(), *col_ops.values()])]
        prev_row, prev_col = row_ops, col_ops
    return b.build()


def summa_noc_trace(mesh, tile_bytes: int, schedule: str = "native",
                    iters: int | None = None, chunks: int = 4, params=None):
    """Deprecated shim: the flat-trace form of :func:`summa_program`.

    Bit-identical to the pre-program emitter; migrate to
    ``summa_program`` (+ ``noc.program.run_program``), which also
    models the double-buffered compute overlap the trace form cannot.
    """
    import warnings

    warnings.warn(
        "summa_noc_trace is deprecated; build a program with "
        "summa.summa_program and run it with noc.program.run_program",
        DeprecationWarning, stacklevel=2)
    return summa_program(mesh, tile_bytes, schedule=schedule, iters=iters,
                         chunks=chunks, params=params).to_trace()


@spanned("summa")
def summa_sharded(A, B, mesh, row_axis="data", col_axis="model",
                  schedule: str = "native", chunks: int = 4):
    """shard_map counterpart: A (M, K), B (K, N), C (M, N) all 2-D block-sharded.

    A and B are global arrays (numpy or tensors); C is a tensor on
    ``mesh.device``.
    """
    spec = (row_axis, col_axis)
    with mesh:
        C = summa(M.shard(A, mesh, spec), M.shard(B, mesh, spec), row_axis, col_axis,
                  schedule=schedule, chunks=chunks)
    return M.unshard(C, mesh, spec)
