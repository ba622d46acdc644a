"""Elastic scaling: re-mesh and lay the live state out again when members
come or go (``src/repro/runtime/elastic.py``).

On a change in the count of healthy members (a lost card, or capacity
added) the runtime 1) builds a new mesh over the survivors, the largest
power-of-two rectangle, which keeps the (dst, mask)-encodable groups of
the collective layer, 2) lays every state leaf out under its spec on the
new mesh, and 3) resumes from the state in memory, with no checkpoint
round trip.  Synchronous SPMD migrates nothing else: the data pipeline is
a pure function of the step (``data/pipeline.py``).

The mesh is stacked on one card (``core.mesh.Mesh``) or one process per
surviving rank (``core.mesh.RankMesh``, ``ranks=True``).  A spec is a
tuple of entries (``None``, an axis name, or a tuple of names), the
port's ``PartitionSpec``; a tree of specs is a dict of them, and may nest.
"""

from __future__ import annotations

from repro_torch.core import mesh as M


def largest_pow2_mesh(members, axis_names=("data", "model"), model_max: int = 16,
                      device=None, ranks: bool = False):
    """The largest power-of-two 2-D mesh over the surviving ``members``:
    ``model`` is the largest power of two up to ``model_max`` that divides
    it, ``data`` the rest.  Stacked on ``device`` (None means CUDA), or,
    with ``ranks``, a rank mesh over the first members (global ranks),
    which every process of the job must build."""
    members = list(members)
    n = 1 << (len(members).bit_length() - 1)  # the largest power of two <= len
    model = min(model_max, n)
    while n % model:
        model //= 2
    shape = (n // model, model)
    if ranks:
        return M.RankMesh(shape, axis_names, device=device, ranks=members[:n])
    return M.Mesh(shape, axis_names, device=device)


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if specs is None else specs.get(k)) for k, v in tree.items()}
    return fn(tree, specs)


def reshard(tree, specs, mesh, src=None):
    """Every leaf of ``tree`` laid out on ``mesh`` under its spec in
    ``specs`` (a matching tree; a missing or ``None`` spec replicates).
    The leaves are global arrays, or, given ``src``, leaves laid out on
    the mesh ``src`` under the same specs, whose global arrays are taken
    first (``core.mesh.unshard``)."""

    def put(x, spec):
        spec = () if spec is None else spec
        if src is not None:
            x = M.unshard(x, src, spec)
        return M.shard(x, mesh, spec)

    return _map(put, tree, specs)


def drop_axis_specs(specs, missing_axes: tuple[str, ...]):
    """Specs rewritten for a mesh that lost some axes (e.g. 'pod' gone):
    the lost axes leave every entry, and an entry left with none is None."""

    def fix(spec):
        if not isinstance(spec, tuple):
            return spec
        parts = []
        for p in spec:
            if p is None:
                parts.append(None)
            elif isinstance(p, (tuple, list)):
                kept = tuple(a for a in p if a not in missing_axes)
                parts.append(kept if kept else None)
            else:
                parts.append(None if p in missing_axes else p)
        return tuple(parts)

    if isinstance(specs, dict):
        return {k: drop_axis_specs(v, missing_axes) for k, v in specs.items()}
    if isinstance(specs, list):
        return [drop_axis_specs(v, missing_axes) for v in specs]
    return fix(specs)
