"""Beyond-paper: latency-hiding collective matmuls.

Port of ``repro.core.overlap``.

* ``ag_matmul``: y = all_gather(x) @ W, computed as a bidirectional ring —
  each step multiplies the resident shard while the next shards stream in
  both ring directions.
* ``matmul_rs``: y = reduce_scatter(x @ W), computed by emitting partial
  products shard-by-shard into a rotating accumulator — the DCA-style
  fused reduction epilogue.

Every per-step product is one batched launch of the ``gemm`` kernel over
all members of the stacked mesh.  ``ag_matmul_program``,
``matmul_rs_program`` and their deprecated ``*_noc_trace`` shims are the
reference's, verbatim but for their imports: the rings as fabric programs.
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as M
from repro_torch.kernels.ops import gemm


def ag_matmul(x_shard, w, axis: str):
    """y = all_gather(x, axis) @ w without materializing the gather.

    x_shard: (..., m, k) — each member's row shard of x;
    w: (..., k, n_cols) — each member's column shard of W (full K rows).
    Returns (..., n_dev * m, n_cols): each member's column block of y.

    Shards stream in BOTH ring directions, so the exposed collective
    latency is ~(n/2 - 1) hops instead of n - 1.
    """
    n = M.axis_size(axis)
    idx = M.axis_index(axis)
    k = M.current().stacked
    m = x_shard.shape[-2]
    w32 = w.float().contiguous()
    out = x_shard.new_zeros((*x_shard.shape[:-2], n, m, w.shape[-1]), dtype=torch.float32)

    def place(out, origin, shard):
        blk = gemm(shard.float().contiguous(), w32)
        return M.put(out, origin, blk, k)

    out = place(out, idx, x_shard)
    fwd = [(p, (p + 1) % n) for p in range(n)]   # receive from idx-1
    bwd = [(p, (p - 1) % n) for p in range(n)]   # receive from idx+1
    a_f, a_b = x_shard, x_shard
    steps_f = n // 2                 # forward stream covers idx-1 .. idx-n//2
    steps_b = (n - 1) // 2           # backward covers idx+1 .. idx+(n-1)//2
    for s in range(1, max(steps_f, steps_b) + 1):
        if s <= steps_f:
            a_f = M.ppermute(a_f, axis, fwd)
            out = place(out, (idx - s) % n, a_f)
        if s <= steps_b:
            a_b = M.ppermute(a_b, axis, bwd)
            out = place(out, (idx + s) % n, a_b)
    return out.flatten(k, k + 1).to(x_shard.dtype)


def matmul_rs(x, w_shard, axis: str):
    """y_shard = reduce_scatter(x @ w, axis) with rotating accumulation.

    x: (..., m, k_local) local K shard; w_shard: (..., k_local, n) matching rows.
    Output: (..., m / n_dev, n) — each member's row shard of y = sum_i x_i @ w_i,
    accumulated ring-wise so each hop adds its local partial product.
    """
    n = M.axis_size(axis)
    idx = M.axis_index(axis)
    k = M.current().stacked
    m = x.shape[-2]
    if m % n:
        raise ValueError(f"rows {m} not divisible by axis size {n}")
    mb = m // n
    perm = [(p, (p + 1) % n) for p in range(n)]
    blocks = x.unflatten(k, (n, mb))
    w32 = w_shard.float().contiguous()

    def partial_block(block_id):
        xs = M.take(blocks, block_id, k)
        return gemm(xs.float().contiguous(), w32)

    # start with the partial for the block owned by my successor-chain tail
    carry = partial_block((idx - 1) % n)
    for step in range(n - 1):
        carry = M.ppermute(carry, axis, perm)
        carry = carry + partial_block((idx - 2 - step) % n)
    return carry.to(x.dtype)  # fully-reduced block ``idx``


# ---------------------------------------------------------------------------
# NoC cost paths: the ring traffic the overlapped matmuls put on the mesh,
# as declarative programs.  One phase per ring step, no barrier ops —
# under window replay phases advance on fabric drain alone, and the wired
# per-op deps (step s's send from tile i forwards the shard tile i
# received at step s-1) give ``run_program(mode='op')`` the exact hop
# pipeline these schedules are designed around.
# ---------------------------------------------------------------------------


def ag_matmul_program(mesh, members, shard_bytes: int):
    """The NoC program of ``ag_matmul``: a bidirectional neighbour ring.

    ``members`` is the ordered ring of ``Coord`` tiles (e.g. one mesh
    row).  Step ``s`` ships every tile's forward shard one hop ahead and
    (while the backward stream is live) its backward shard one hop back,
    both directions sharing the fabric.
    """
    from repro_torch.core.noc.program import ProgramBuilder

    n = len(members)
    b = ProgramBuilder(mesh)
    steps_f, steps_b = n // 2, (n - 1) // 2
    prev_f: dict[int, int] = {}
    prev_b: dict[int, int] = {}
    for s in range(max(steps_f, steps_b)):
        cur_f: dict[int, int] = {}
        cur_b: dict[int, int] = {}
        for i in range(n):
            if s < steps_f:
                cur_f[i] = b.unicast(
                    members[i], members[(i + 1) % n], shard_bytes, phase=s,
                    deps=prev_f.get((i - 1) % n))
            if s < steps_b:
                cur_b[i] = b.unicast(
                    members[i], members[(i - 1) % n], shard_bytes, phase=s,
                    deps=prev_b.get((i + 1) % n))
        prev_f, prev_b = cur_f, cur_b
    return b.build()


def matmul_rs_program(mesh, members, block_bytes: int):
    """The NoC program of ``matmul_rs``: a unidirectional accumulation
    ring (tile ``i`` forwards at step ``s`` the partial sum it received
    from ``i - 1`` at step ``s - 1``)."""
    from repro_torch.core.noc.program import ProgramBuilder

    n = len(members)
    b = ProgramBuilder(mesh)
    prev: dict[int, int] = {}
    for s in range(n - 1):
        cur: dict[int, int] = {}
        for i in range(n):
            cur[i] = b.unicast(
                members[i], members[(i + 1) % n], block_bytes, phase=s,
                deps=prev.get((i - 1) % n))
        prev = cur
    return b.build()


def ag_matmul_noc_trace(mesh, members, shard_bytes: int):
    """Deprecated shim: flat-trace form of :func:`ag_matmul_program`."""
    import warnings

    warnings.warn(
        "ag_matmul_noc_trace is deprecated; build a program with "
        "overlap.ag_matmul_program and run it with noc.program.run_program",
        DeprecationWarning, stacklevel=2)
    return ag_matmul_program(mesh, members, shard_bytes).to_trace()


def matmul_rs_noc_trace(mesh, members, block_bytes: int):
    """Deprecated shim: flat-trace form of :func:`matmul_rs_program`."""
    import warnings

    warnings.warn(
        "matmul_rs_noc_trace is deprecated; build a program with "
        "overlap.matmul_rs_program and run it with noc.program.run_program",
        DeprecationWarning, stacklevel=2)
    return matmul_rs_program(mesh, members, block_bytes).to_trace()


def ag_matmul_sharded(x, w, mesh, axis: str = "model"):
    with mesh:
        y = ag_matmul(M.shard(x, mesh, (axis, None)), M.shard(w, mesh, (None, axis)), axis)
    return M.unshard(y, mesh, (None, axis))


def matmul_rs_sharded(x, w, mesh, axis: str = "model"):
    with mesh:
        y = matmul_rs(M.shard(x, mesh, (None, axis)), M.shard(w, mesh, (axis, None)), axis)
    return M.unshard(y, mesh, (axis, None))
