"""SUMMA GEMM on a 2-D mesh (Section 4.3.1, Fig. 8a).

Port of ``repro.core.summa`` (the execution half).  ``C = A @ B`` with both
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
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as M
from repro_torch.core import schedules as sched
from repro_torch.kernels.ops import gemm


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
