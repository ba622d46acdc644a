"""Collective schedules: the paper's SW baselines and HW path, on mesh axes.

Port of ``repro.core.schedules``.  Each schedule is an
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

The fabric-program emitters at the end (``broadcast_ops``,
``all_reduce_ops`` and their deprecated ``*_noc_events`` shims) are the
reference's, verbatim but for their imports: they append a schedule's
traffic to a ``noc.program.ProgramBuilder`` for the flit-level simulator.
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


# ---------------------------------------------------------------------------
# NoC cost paths: map each schedule onto the fabric traffic it generates.
#
# These emitters mirror the taxonomy above one-to-one but append typed
# ops to a ``noc.program.ProgramBuilder`` (src/dst streams with
# model-derived start offsets), so a whole schedule becomes part of a
# declarative ``Program`` that ``noc.program.run_program`` executes
# *under shared-fabric contention* — composing end-to-end workload
# estimates with interference, which summing the idle-network model
# times of ``noc/model.py`` cannot do.  The start offsets within one
# collective are the analytical per-stage terms (Eqs 1-6), so flattening
# the ops back to a trace reproduces the historical ``*_noc_events``
# output bit-for-bit (the native all-reduce needs ``pipeline="offsets"``
# for that; its default wires a true reduction→multicast dep instead);
# cross-collective sequencing is expressed through the ``deps`` argument
# (per-op gating) or the ``phase`` stamp (barrier/window modes).
# ---------------------------------------------------------------------------


def broadcast_ops(builder, members, root: int = 0, nbytes: int = 0,
                  schedule: str = "native", chunks: int = 1, deps=None,
                  phase: int | None = None, params=None) -> list[int]:
    """Append the fabric traffic of ``broadcast`` to ``builder``.

    ``members`` is the ordered list of ``Coord`` tiles forming the axis
    (a mesh row/column for the paper's collectives).  Every emitted op
    carries ``deps`` (its release gate under per-op execution) and
    ``phase``; stage start offsets follow the per-stage terms of the
    analytical models (Eqs 1-4).  Returns the new op ids.
    """
    from repro_torch.core.noc.params import NoCParams
    from repro_torch.core.topology import multi_address_for

    p = params or NoCParams()
    n = len(members)
    _check_pow2(n, "broadcast_ops")
    beats = p.beats(nbytes)
    if schedule == "native":
        ma = multi_address_for(members)
        return [builder.multicast(members[root], ma, nbytes, deps=deps,
                                  phase=phase)]
    out = []
    if schedule in ("chain", "pipelined"):
        k = chunks if schedule == "pipelined" else 1
        chunk_bytes = max(1, nbytes // k)
        stage = p.alpha(1) + p.beats(chunk_bytes) * p.beta + p.delta
        for i in range(n - 1):
            src, dst = members[(root + i) % n], members[(root + i + 1) % n]
            for j in range(k):
                out.append(builder.unicast(src, dst, chunk_bytes,
                                           start=(i + j) * stage, deps=deps,
                                           phase=phase))
        return out
    if schedule == "tree":
        t = 0.0
        for s in range(n.bit_length() - 1):
            dist = 1 << s
            for i in range(dist):
                src = members[(root + i) % n]
                dst = members[(root + i + dist) % n]
                out.append(builder.unicast(src, dst, nbytes, start=t,
                                           deps=deps, phase=phase))
            t += p.alpha(dist) + beats * p.beta + p.delta
        return out
    raise ValueError(f"unknown schedule {schedule!r}")


def all_reduce_ops(builder, members, nbytes: int = 0, schedule: str = "native",
                   root: int = 0, deps=None, phase: int | None = None,
                   params=None, pipeline: str = "deps") -> list[int]:
    """Append the fabric traffic of ``all_reduce`` to ``builder``.

    The native path is the paper's AXI coupling: one wide in-network
    reduction into ``members[root]`` followed by a multicast of the
    result.  ``pipeline`` selects how that ordering is expressed:

    * ``"deps"`` (default) — the multicast *depends on* the reduction op,
      so per-op execution (``run_program(mode='op')``) is exactly causal
      even when contention delays the reduction.  This form does not
      flatten to the legacy trace (``to_trace`` drops deps, leaving the
      pair concurrent under barrier/window replay).
    * ``"offsets"`` — the multicast injects at the analytic reduction
      model time (``model.reduction_hw``) with no dep edge: the
      flat-trace emulation the deprecated ``all_reduce_noc_events`` shim
      flattens bit-identically, correct under barrier/window modes but
      optimistic under ``mode='op'`` if the simulated reduction runs
      longer than the model.

    Returns the new op ids.
    """
    from repro_torch.core.noc import model as m
    from repro_torch.core.noc.params import NoCParams
    from repro_torch.core.topology import multi_address_for

    if pipeline not in ("deps", "offsets"):
        raise ValueError(f"pipeline must be 'deps' or 'offsets', got {pipeline!r}")
    p = params or NoCParams()
    n = len(members)
    _check_pow2(n, "all_reduce_ops")
    beats = p.beats(nbytes)
    if schedule == "native":
        ma = multi_address_for(members)
        red = builder.reduction(members, members[root], nbytes, deps=deps,
                                phase=phase)
        if pipeline == "deps":
            mc = builder.multicast(members[root], ma, nbytes,
                                   deps=[deps, red], phase=phase)
        else:
            t_red = m.reduction_hw(p, beats, n)
            mc = builder.multicast(members[root], ma, nbytes, start=t_red,
                                   deps=deps, phase=phase)
        return [red, mc]
    out = []
    if schedule == "tree":
        t = 0.0
        stage = p.alpha(1) + beats * p.beta + max(beats * p.beta_c, 0.0) + p.delta
        for s in range(n.bit_length() - 1):
            dist = 1 << s
            for i in range(n):
                out.append(builder.unicast(members[i], members[i ^ dist],
                                           nbytes, start=t, deps=deps,
                                           phase=phase))
            t += stage
        return out
    if schedule in ("chain", "pipelined"):
        # ring reduce-scatter + all-gather; 'chain' moves whole tensors,
        # 'pipelined' moves 1/n chunks (the software k = n limit).
        chunk_bytes = max(1, nbytes // n) if schedule == "pipelined" else nbytes
        stage = p.alpha(1) + p.beats(chunk_bytes) * p.beta + p.delta
        steps = 2 * (n - 1) if schedule == "pipelined" else n - 1
        for s in range(steps):
            for i in range(n):
                out.append(builder.unicast(members[i], members[(i + 1) % n],
                                           chunk_bytes, start=s * stage,
                                           deps=deps, phase=phase))
        return out
    raise ValueError(f"unknown schedule {schedule!r}")


def _member_builder(members):
    """A builder over the bounding mesh of ``members`` (shim helper: the
    legacy event emitters never knew the mesh, only the axis tiles)."""
    from repro_torch.core.noc.program import ProgramBuilder
    from repro_torch.core.topology import Mesh2D

    cols = max(x for x, _ in (tuple(c) for c in members)) + 1
    rows = max(y for _, y in (tuple(c) for c in members)) + 1
    return ProgramBuilder(Mesh2D(cols, rows))


def broadcast_noc_events(members, root: int, nbytes: int, schedule: str = "native",
                         chunks: int = 1, phase: int = 0, params=None):
    """Deprecated shim: flat-event form of :func:`broadcast_ops`.

    Returns the bit-identical ``TrafficEvent`` list the pre-program
    emitter produced; migrate to ``broadcast_ops`` + ``ProgramBuilder``.
    """
    import warnings

    warnings.warn(
        "broadcast_noc_events is deprecated; emit through "
        "noc.program.ProgramBuilder via schedules.broadcast_ops",
        DeprecationWarning, stacklevel=2)
    b = _member_builder(members)
    broadcast_ops(b, members, root=root, nbytes=nbytes, schedule=schedule,
                  chunks=chunks, phase=phase, params=params)
    return b.build().to_events()


def all_reduce_noc_events(members, nbytes: int, schedule: str = "native",
                          root: int = 0, phase: int = 0, params=None):
    """Deprecated shim: flat-event form of :func:`all_reduce_ops`.

    Returns the bit-identical ``TrafficEvent`` list the pre-program
    emitter produced; migrate to ``all_reduce_ops`` + ``ProgramBuilder``.
    """
    import warnings

    warnings.warn(
        "all_reduce_noc_events is deprecated; emit through "
        "noc.program.ProgramBuilder via schedules.all_reduce_ops",
        DeprecationWarning, stacklevel=2)
    b = _member_builder(members)
    all_reduce_ops(b, members, nbytes=nbytes, schedule=schedule, root=root,
                   phase=phase, params=params, pipeline="offsets")
    return b.build().to_events()
