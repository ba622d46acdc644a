"""Policy-generic multicast fork trees and reduction join trees.

The legacy builders in ``repro_torch.core.topology`` hard-code XY (fork) and
its YX mirror (join).  These generalizations build the same tree shapes
from *any* deterministic policy:

* **fork tree** — destinations are visited in sorted order; each
  destination's ``tree_route`` is grafted onto the tree at its *deepest*
  already-in-tree node, so every node keeps exactly one parent (an
  out-tree) even for policies whose unicast paths can re-converge after
  diverging (odd-even).
* **join tree** — each source's ``join_route`` is walked toward the root
  and grafted at its *first* already-in-tree node, so every node keeps
  exactly one output (an in-tree); past the graft point the flow follows
  the existing tree.

For dimension-ordered policies the per-destination paths never rejoin
(the prefix/suffix property), so grafting degenerates to the plain path
union and the result is bit-identical to the legacy XY builders — the
``xy`` policy dispatches straight to them (and tests assert the generic
construction agrees).  Results are memoized on
``(policy name, mesh, addresses)`` exactly like the legacy caches, and
callers get fresh copies so mutation cannot poison the cache.
"""

from __future__ import annotations

import functools
from typing import Sequence

from repro_torch.core.noc.routing.policies import RoutingPolicy, get_policy
from repro_torch.core.topology import (
    Coord,
    Mesh2D,
    MultiAddress,
    _multicast_fork_tree_cached,
    _reduction_join_tree_cached,
)


def fork_tree(
    mesh: Mesh2D, src: Coord, maddr: MultiAddress,
    policy: RoutingPolicy | str = "xy",
) -> dict[Coord, set[Coord]]:
    """Per-router fork map ``{router: {next hops (self = local delivery)}}``
    for a multicast built from ``policy.tree_route``."""
    if isinstance(policy, str):
        policy = get_policy(policy)
    if policy.tree_routes_are_xy:  # declared by the policy: legacy fast path
        cached = _multicast_fork_tree_cached(mesh, src, maddr)
    else:
        cached = _fork_tree_cached(policy.name, mesh, src, maddr)
    return {k: set(v) for k, v in cached.items()}


def join_tree(
    mesh: Mesh2D, sources: Sequence[Coord], dst: Coord,
    policy: RoutingPolicy | str = "xy",
) -> dict[Coord, set[Coord]]:
    """Per-router join map ``{router: {inputs (self = local contribution)}}``
    for a reduction built from ``policy.join_route``."""
    if isinstance(policy, str):
        policy = get_policy(policy)
    if policy.tree_routes_are_xy:  # declared by the policy: legacy fast path
        cached = _reduction_join_tree_cached(mesh, tuple(sources), dst)
    else:
        cached = _join_tree_cached(policy.name, mesh, tuple(sources), dst)
    return {k: set(v) for k, v in cached.items()}


@functools.lru_cache(maxsize=4096)
def _fork_tree_cached(
    policy_name: str, mesh: Mesh2D, src: Coord, maddr: MultiAddress
) -> dict[Coord, frozenset[Coord]]:
    policy = get_policy(policy_name)
    fork: dict[Coord, set[Coord]] = {}
    in_tree = {src}
    for dst in sorted(maddr.destinations(mesh), key=tuple):
        path = policy.tree_route(mesh, src, dst)
        # Graft at the deepest in-tree node: everything after it is new,
        # so each grafted node acquires exactly one parent.
        start = max(i for i, n in enumerate(path) if n in in_tree)
        for a, b in zip(path[start:], path[start + 1:]):
            fork.setdefault(a, set()).add(b)
            in_tree.add(b)
        fork.setdefault(dst, set()).add(dst)  # local delivery
    return {k: frozenset(v) for k, v in fork.items()}


@functools.lru_cache(maxsize=4096)
def _join_tree_cached(
    policy_name: str, mesh: Mesh2D, sources: tuple[Coord, ...], dst: Coord
) -> dict[Coord, frozenset[Coord]]:
    policy = get_policy(policy_name)
    join: dict[Coord, set[Coord]] = {}
    in_tree = {dst}  # nodes that already have an output (or are the root)
    for s in sources:
        path = policy.join_route(mesh, s, dst)
        join.setdefault(s, set()).add(s)  # local contribution
        for a, b in zip(path, path[1:]):
            if a in in_tree:
                break  # flow continues along the existing tree
            join.setdefault(b, set()).add(a)
            in_tree.add(a)
    return {k: frozenset(v) for k, v in join.items()}
