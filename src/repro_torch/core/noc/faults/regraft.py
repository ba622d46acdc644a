"""Collective-tree re-grafting around faulted nodes and links.

Degraded multicast fork trees and reduction join trees are rebuilt with
exactly the grafting discipline of ``routing/trees.py`` — destinations
visited in sorted order and grafted at the **deepest** already-in-tree
node of their route (fork), sources walked toward the root and grafted
at the **first** already-in-tree node (join) — which preserves the tree
validity invariants the simulator's lockstep beat expansion depends on:
every fork-tree node has exactly one parent (an out-tree, every
destination locally delivered), every join-tree node except the root
forwards to exactly one output (an in-tree, every source locally
contributed).

Per-leg routes come from the base policy when its ``tree_route`` /
``join_route`` is fully healthy, else from the plain-BFS
:func:`~repro_torch.core.noc.faults.repair.healthy_path` (shortest healthy
path, no turn constraints — collective trees are the lockstep mechanism
excluded from the unicast escape-VC deadlock argument; their contract is
the validity invariants above, checked by :func:`check_fork_tree` /
:func:`check_join_tree` and the property tests).

Dead *destinations* of a multicast and dead *sources* of a reduction are
dropped from the tree (the collective completes over the survivors,
mirroring how ``runtime/elastic.py`` shrinks the device mesh); a dead
multicast source, a dead reduction root, or a live-but-partitioned
endpoint raises :class:`~repro_torch.core.noc.faults.model.FaultDisconnectedError`
with the endpoint and the fault pattern.

Results are memoized on ``(policy name, mesh, addresses, faults)`` —
:class:`FaultSet` is frozen and hashable precisely so it can key these
caches — and callers receive fresh copies, like ``trees.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

from repro_torch.core.noc.faults.model import FaultDisconnectedError, FaultSet
from repro_torch.core.noc.faults.repair import healthy_path, route_is_healthy
from repro_torch.core.noc.routing.policies import RoutingPolicy, get_policy
from repro_torch.core.topology import Coord, Mesh2D, MultiAddress


@dataclasses.dataclass(frozen=True)
class RegraftInfo:
    """What re-grafting changed relative to the healthy tree."""

    rerouted: int = 0                       # legs that needed a healthy-BFS path
    dropped: tuple[Coord, ...] = ()         # dead endpoints removed from the tree

    @property
    def changed(self) -> bool:
        return bool(self.rerouted or self.dropped)


def _tree_leg(mesh: Mesh2D, faults: FaultSet, policy: RoutingPolicy,
              src: Coord, dst: Coord, join: bool) -> tuple[tuple[Coord, ...], bool]:
    base = (policy.join_route if join else policy.tree_route)(mesh, src, dst)
    if route_is_healthy(faults, base):
        return base, False
    return healthy_path(mesh, faults, src, dst), True


@functools.lru_cache(maxsize=4096)
def _fork_tree_degraded_cached(
    policy_name: str, mesh: Mesh2D, src: Coord, maddr: MultiAddress,
    faults: FaultSet,
) -> tuple[dict[Coord, frozenset[Coord]], RegraftInfo]:
    policy = get_policy(policy_name)
    if faults.router_is_dead(src):
        raise FaultDisconnectedError(
            f"multicast source ({src.x},{src.y}) is a dead router "
            f"({faults.describe()})")
    fork: dict[Coord, set[Coord]] = {}
    in_tree = {src}
    rerouted = 0
    dropped: list[Coord] = []
    for dst in sorted(maddr.destinations(mesh), key=tuple):
        if faults.router_is_dead(dst):
            dropped.append(dst)
            continue
        path, detoured = _tree_leg(mesh, faults, policy, src, dst, join=False)
        rerouted += detoured
        # Deepest in-tree graft, as in trees.py: everything after the
        # graft point is new, so each node acquires exactly one parent.
        start = max(i for i, n in enumerate(path) if n in in_tree)
        for a, b in zip(path[start:], path[start + 1:]):
            fork.setdefault(a, set()).add(b)
            in_tree.add(b)
        fork.setdefault(dst, set()).add(dst)  # local delivery
    if not dropped and rerouted == 0:
        # Bit-identical to the healthy tree by construction; still report
        # an unchanged RegraftInfo so callers need no special case.
        pass
    return ({k: frozenset(v) for k, v in fork.items()},
            RegraftInfo(rerouted=rerouted, dropped=tuple(dropped)))


def fork_tree_degraded(
    mesh: Mesh2D, src: Coord, maddr: MultiAddress,
    policy: RoutingPolicy | str = "xy", faults: FaultSet | None = None,
) -> tuple[dict[Coord, set[Coord]], RegraftInfo]:
    """Degraded multicast fork map ``{router: {next hops (self = local
    delivery)}}`` plus what changed.  With no (or empty) faults this is
    exactly ``trees.fork_tree``."""
    name = policy if isinstance(policy, str) else policy.name
    if faults is None or faults.empty:
        from repro_torch.core.noc.routing.trees import fork_tree

        return fork_tree(mesh, src, maddr, policy=name), RegraftInfo()
    cached, info = _fork_tree_degraded_cached(name, mesh, src, maddr, faults)
    return {k: set(v) for k, v in cached.items()}, info


@functools.lru_cache(maxsize=4096)
def _join_tree_degraded_cached(
    policy_name: str, mesh: Mesh2D, sources: tuple[Coord, ...], dst: Coord,
    faults: FaultSet,
) -> tuple[dict[Coord, frozenset[Coord]], RegraftInfo]:
    policy = get_policy(policy_name)
    if faults.router_is_dead(dst):
        raise FaultDisconnectedError(
            f"reduction root ({dst.x},{dst.y}) is a dead router "
            f"({faults.describe()})")
    join: dict[Coord, set[Coord]] = {}
    in_tree = {dst}  # nodes that already have an output (or are the root)
    rerouted = 0
    dropped: list[Coord] = []
    for s in sources:
        if faults.router_is_dead(s):
            dropped.append(s)
            continue
        path, detoured = _tree_leg(mesh, faults, policy, s, dst, join=True)
        rerouted += detoured
        join.setdefault(s, set()).add(s)  # local contribution
        for a, b in zip(path, path[1:]):
            if a in in_tree:
                break  # flow continues along the existing tree
            join.setdefault(b, set()).add(a)
            in_tree.add(a)
    return ({k: frozenset(v) for k, v in join.items()},
            RegraftInfo(rerouted=rerouted, dropped=tuple(dropped)))


def join_tree_degraded(
    mesh: Mesh2D, sources: Sequence[Coord], dst: Coord,
    policy: RoutingPolicy | str = "xy", faults: FaultSet | None = None,
) -> tuple[dict[Coord, set[Coord]], RegraftInfo]:
    """Degraded reduction join map ``{router: {inputs (self = local
    contribution)}}`` plus what changed.  With no (or empty) faults this
    is exactly ``trees.join_tree``."""
    name = policy if isinstance(policy, str) else policy.name
    if faults is None or faults.empty:
        from repro_torch.core.noc.routing.trees import join_tree

        return join_tree(mesh, sources, dst, policy=name), RegraftInfo()
    cached, info = _join_tree_degraded_cached(
        name, mesh, tuple(sources), dst, faults)
    return {k: set(v) for k, v in cached.items()}, info


# ---------------------------------------------------------------------------
# Validity invariants (the contract the property tests assert).
# ---------------------------------------------------------------------------


def check_fork_tree(mesh: Mesh2D, fork: dict[Coord, set[Coord]], src: Coord,
                    dests: Sequence[Coord],
                    faults: FaultSet | None = None) -> None:
    """Out-tree invariants: every non-source node has exactly one parent,
    every (live) destination is locally delivered, no edge touches a
    faulted element."""
    parents: dict[Coord, int] = {}
    for a, hops in fork.items():
        for b in hops:
            if b == a:
                continue
            parents[b] = parents.get(b, 0) + 1
            if faults is not None and faults.link_is_dead(a, b):
                raise AssertionError(
                    f"fork tree uses faulted link ({a.x},{a.y})->({b.x},{b.y})")
    bad = [n for n, k in parents.items() if k != 1]
    if bad or src in parents:
        raise AssertionError(f"fork tree is not an out-tree: {bad or [src]}")
    for d in dests:
        if faults is not None and faults.router_is_dead(d):
            if d in fork:
                raise AssertionError(f"dead destination {tuple(d)} in tree")
            continue
        if d not in fork or d not in fork[d]:
            raise AssertionError(f"destination {tuple(d)} lacks local delivery")


def check_join_tree(mesh: Mesh2D, join: dict[Coord, set[Coord]], dst: Coord,
                    sources: Sequence[Coord],
                    faults: FaultSet | None = None) -> None:
    """In-tree invariants: every router except the root forwards to
    exactly one output, every (live) source locally contributes, no edge
    touches a faulted element."""
    outputs: dict[Coord, int] = {}
    for b, inputs in join.items():
        for a in inputs:
            if a == b:
                continue
            outputs[a] = outputs.get(a, 0) + 1
            if faults is not None and faults.link_is_dead(a, b):
                raise AssertionError(
                    f"join tree uses faulted link ({a.x},{a.y})->({b.x},{b.y})")
    bad = [n for n, k in outputs.items() if k != 1]
    if bad or dst in outputs:
        raise AssertionError(f"join tree is not an in-tree: {bad or [dst]}")
    for s in sources:
        if faults is not None and faults.router_is_dead(s):
            if any(s in inputs for inputs in join.values()) or s in join:
                raise AssertionError(f"dead source {tuple(s)} in tree")
            continue
        if s not in join or s not in join[s]:
            raise AssertionError(f"source {tuple(s)} lacks local contribution")
