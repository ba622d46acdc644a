"""Collective schedules: the paper's SW baselines and HW path, on mesh axes.

Port of ``repro.core.schedules`` (the collective half).  Each schedule is an
SPMD program over one named axis of the stacked mesh (``core.mesh``): a
tensor's leading dims are the mesh members, and a member's dim 0 in the
reference body is dim ``mesh.ndim`` here.  The taxonomy is the reference's:

  paper (Section 4.2)                    here
  -------------------------------------  -------------------------------------
  naive sequential multicast   (Eq 1)    ``broadcast(..., schedule="chain")``
  pipelined sequential         (Eq 2)    ``broadcast(..., schedule="pipelined", chunks=k)``
  binary-tree multicast        (Eq 3)    ``broadcast(..., schedule="tree")``
  in-network (HW) multicast    (Eq 4)    ``broadcast(..., schedule="native")``
  sequential reduction         (Eq 5)    ``all_reduce(..., schedule="chain")``
  tree reduction               (Eq 6)    ``all_reduce(..., schedule="tree")``
  in-network (HW) reduction + DCA        ``all_reduce(..., "native")`` /
                                         ``reduce_scatter`` fused into the consumer
  LsbAnd barrier               (4.2.1)   ``barrier(axis)``

The native schedules are one in-network reduction each: the
``reduce_nway`` kernel over the axis' dim (``mesh.psum``).  The software
schedules are chains of ``ppermute`` steps with plain adds, step for step
as in the reference.

All schedules assume a power-of-two axis size, matching the paper's
(dst, mask) submesh constraint (Section 3.2.2) — enforced here.
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as M

SCHEDULES = ("native", "chain", "pipelined", "tree")


def _check_pow2(n: int, what: str):
    if n & (n - 1):
        raise ValueError(
            f"{what}: axis size {n} is not a power of two — collective groups "
            "must satisfy the (dst, mask) submesh-encoding constraint")


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def _xor_perm(n: int, mask: int):
    return [(i, i ^ mask) for i in range(n)]


def _split(x, parts: int, dim: int):
    """``jnp.split`` into equal parts: raises when they do not divide."""
    if x.shape[dim] % parts:
        raise ValueError(f"dim of size {x.shape[dim]} does not split into {parts} equal parts")
    return list(x.split(x.shape[dim] // parts, dim=dim))


def _where(cond, a, b):
    return torch.where(M.lift(cond, a), a, b)


# ---------------------------------------------------------------------------
# Broadcast (paper: multicast)
# ---------------------------------------------------------------------------


def broadcast(x, axis: str, root: int = 0, schedule: str = "native", chunks: int = 1):
    """Broadcast ``x`` from ``root`` along ``axis`` to all members."""
    n = M.axis_size(axis)
    _check_pow2(n, "broadcast")
    idx = M.axis_index(axis)
    if schedule == "native":
        # In-network multicast: one reduction in which only the root adds
        # a non-zero term (exact), as in the reference.
        masked = _where(idx == root, x, torch.zeros_like(x))
        return M.psum(masked, axis)
    if schedule == "chain":
        return _broadcast_chain(x, axis, root, n, idx, chunks=1)
    if schedule == "pipelined":
        return _broadcast_chain(x, axis, root, n, idx, chunks=chunks)
    if schedule == "tree":
        return _broadcast_tree(x, axis, root, n, idx)
    raise ValueError(f"unknown schedule {schedule!r}")


def _broadcast_chain(x, axis, root, n, idx, chunks: int):
    """Neighbour chain from the root (Eq 1); ``chunks>1`` pipelines it (Eq 2).

    Executes n-1 ppermute steps per chunk; chunk c's step s moves the chunk
    from relative position s to s+1.  SPMD-uniform: every member runs every
    step; non-participants forward zeros that are masked out.
    """
    k = M.current().ndim
    rel = (idx - root) % n  # my distance down the chain
    parts = _split(x, chunks, k) if chunks > 1 else [x]
    out_parts = []
    perm = _ring_perm(n)
    for part in parts:
        have = _where(rel == 0, part, torch.zeros_like(part))
        acc = have
        for _ in range(n - 1):
            have = M.ppermute(have, axis, perm)
            acc = acc + have  # each member receives its copy exactly once
        out_parts.append(acc)
    return torch.cat(out_parts, dim=k) if chunks > 1 else out_parts[0]


def _broadcast_tree(x, axis, root, n, idx):
    """Recursive-doubling broadcast (Eq 3): log2(n) ppermute stages."""
    rel = (idx - root) % n
    have = _where(rel == 0, x, torch.zeros_like(x))
    stages = n.bit_length() - 1
    for i in range(stages):
        dist = 1 << i
        perm = [(j, (j + dist) % n) for j in range(n)]
        recv = M.ppermute(have, axis, perm)
        # members with rel >= dist receive from rel - dist
        have = _where((rel >= dist) & (rel < 2 * dist), recv, have)
    return have


# ---------------------------------------------------------------------------
# All-reduce (paper: reduction; result delivered to all = reduction+multicast,
# the AXI coupling of Section 3.1)
# ---------------------------------------------------------------------------


def all_reduce(x, axis: str, schedule: str = "native", chunks: int = 1):
    n = M.axis_size(axis)
    _check_pow2(n, "all_reduce")
    if schedule == "native":
        return M.psum(x, axis)
    if schedule == "tree":
        # recursive doubling: log2(n) full-size exchanges
        out = x
        for i in range(n.bit_length() - 1):
            recv = M.ppermute(out, axis, _xor_perm(n, 1 << i))
            out = out + recv
        return out
    if schedule in ("chain", "pipelined"):
        # ring reduce-scatter + ring all-gather; "chain" moves whole tensors,
        # "pipelined" moves 1/n chunks (the k=n limit of Eq 2 in software).
        if schedule == "chain":
            acc = x
            for _ in range(n - 1):
                acc = M.ppermute(acc, axis, _ring_perm(n)) + x
            return acc
        return _ring_all_reduce(x, axis, n)
    raise ValueError(f"unknown schedule {schedule!r}")


def _ring_all_reduce(x, axis, n):
    """Bandwidth-optimal ring: RS then AG on 1/n chunks."""
    k = M.current().ndim
    idx = M.axis_index(axis)
    rows = x.shape[k]
    pad = (-rows) % n
    if pad:
        shape = list(x.shape)
        shape[k] = pad
        xp = torch.cat([x, x.new_zeros(shape)], dim=k)
    else:
        xp = x
    parts = xp.unflatten(k, (n, -1))  # (..., n, m/n, ...)
    # ring reduce-scatter: member i starts with its copy of chunk (i-1); at
    # step s it receives the partial sum of chunk (i-2-s) and adds its own
    # copy; after n-1 hops member i holds the fully-reduced chunk i.
    carry = M.take(parts, (idx - 1) % n, k)
    for step in range(n - 1):
        carry = M.ppermute(carry, axis, _ring_perm(n))
        carry = carry + M.take(parts, (idx - 2 - step) % n, k)
    # all-gather the reduced chunks around the ring
    gathered = [carry]
    g = carry
    for _ in range(n - 1):
        g = M.ppermute(g, axis, _ring_perm(n))
        gathered.append(g)
    # member i received chunks in order [i, i-1, i-2, ...]; reassemble to 0..n-1
    stackd = torch.stack(gathered, dim=k)  # position p holds chunk (i - p) mod n
    order = (idx[..., None] - torch.arange(n, device=x.device)) % n
    out = torch.zeros_like(stackd).scatter(k, M.lift(order, stackd).expand(stackd.shape), stackd)
    out = out.flatten(k, k + 1)
    return out.narrow(k, 0, rows) if pad else out


# ---------------------------------------------------------------------------
# All-gather / reduce-scatter
# ---------------------------------------------------------------------------


def all_gather(x, axis: str, schedule: str = "native"):
    """Gather shards along a new leading dim -> concatenated on dim 0."""
    n = M.axis_size(axis)
    _check_pow2(n, "all_gather")
    if schedule == "native":
        return M.all_gather(x, axis, tiled=True)
    k = M.current().ndim
    idx = M.axis_index(axis)
    if schedule in ("chain", "pipelined"):
        gathered = [x]
        g = x
        for _ in range(n - 1):
            g = M.ppermute(g, axis, _ring_perm(n))
            gathered.append(g)
        stackd = torch.stack(gathered, dim=k)  # position p holds shard (i - p) mod n
        order = (idx[..., None] - torch.arange(n, device=x.device)) % n
        out = torch.zeros_like(stackd).scatter(
            k, M.lift(order, stackd).expand(stackd.shape), stackd)
        return out.flatten(k, k + 1)
    if schedule == "tree":
        # recursive doubling all-gather
        block = x.unsqueeze(k)  # (..., 1, ...)
        for i in range(n.bit_length() - 1):
            dist = 1 << i
            recv = M.ppermute(block, axis, _xor_perm(n, dist))
            low = (idx & dist) == 0
            cat_lo = torch.cat([block, recv], dim=k)
            cat_hi = torch.cat([recv, block], dim=k)
            block = _where(low, cat_lo, cat_hi)
        return block.flatten(k, k + 1)
    raise ValueError(f"unknown schedule {schedule!r}")


def reduce_scatter(x, axis: str, schedule: str = "native"):
    """Sum over the axis, scattering dim 0: (m, ...) -> (m/n, ...).

    The DCA analogue: the reduction lands directly in the consumer's shard,
    with the adds executed by the receiving core's VPU along the path.
    """
    n = M.axis_size(axis)
    _check_pow2(n, "reduce_scatter")
    if schedule == "native":
        return M.psum_scatter(x, axis, tiled=True)
    k = M.current().ndim
    idx = M.axis_index(axis)
    parts = torch.stack(_split(x, n, k), dim=k)
    carry = M.take(parts, (idx - 1) % n, k)
    for step in range(n - 1):
        carry = M.ppermute(carry, axis, _ring_perm(n))
        carry = carry + M.take(parts, (idx - 2 - step) % n, k)
    return carry


def barrier(axis: str, schedule: str = "native"):
    """LsbAnd-analogue barrier: a 1-element reduction over the axis.

    Returns every member's count of arrivals (the axis size), int32.
    """
    mesh = M.current()
    token = torch.ones(mesh.shape, dtype=torch.int32, device=mesh.device)
    if schedule == "native":
        return M.psum(token, axis)
    return all_reduce(token.unsqueeze(mesh.ndim), axis, schedule="tree")[..., 0]
