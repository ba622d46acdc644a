"""Turn-model deadlock-freedom checks for routing policies.

A wormhole network is deadlock-free if the channel dependency graph
(CDG) — directed links as nodes, an edge wherever some packet can hold
link A while requesting link B — is acyclic (Dally & Seitz).  For a
deterministic policy the CDG is computable exactly: enumerate every
route the policy can emit on a mesh and record each consecutive link
pair as a dependency.

Policies with ``route_classes > 1`` (O1TURN) are validated per class:
each class must be acyclic on its own virtual network, while the union
may (and for O1TURN does) contain cycles — that is precisely why O1TURN
needs one VC per class, and ``min_vcs_for_deadlock_freedom`` reports it.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from repro_torch.core.topology import Coord, Mesh2D

Link = tuple[Coord, Coord]

# Canonical direction names for turn reporting.
_DIR_NAMES = {(1, 0): "E", (-1, 0): "W", (0, 1): "N", (0, -1): "S"}


def _link_dir(link: Link) -> tuple[int, int]:
    a, b = link
    return (b.x - a.x, b.y - a.y)


def route_turns(path: Sequence[Coord]) -> list[tuple[Link, Link]]:
    """Consecutive link pairs (the turns, plus straight-throughs) of a path."""
    links = list(zip(path, path[1:]))
    return list(zip(links, links[1:]))


def policy_dependencies(
    policy, mesh: Mesh2D, route_class: int | None = None,
    packet_ids: Iterable[int] | None = None,
) -> set[tuple[Link, Link]]:
    """All link-to-link dependencies ``policy`` can generate on ``mesh``.

    ``route_class`` restricts enumeration to packets of one class;
    ``packet_ids`` defaults to one id per class (routes are class-pure
    by definition of :meth:`RoutingPolicy.route_class`) plus a few extra
    draws so packet-seeded tie-breaks (odd-even) are sampled.
    """
    if packet_ids is None:
        packet_ids = range(max(policy.route_classes, 1) * 2)
    deps: set[tuple[Link, Link]] = set()
    for pid in packet_ids:
        if route_class is not None and policy.route_class(pid) != route_class:
            continue
        for src in mesh.coords():
            for dst in mesh.coords():
                if src == dst:
                    continue
                deps.update(route_turns(policy.route(mesh, src, dst, pid)))
    return deps


def has_cycle(deps: set[tuple[Link, Link]]) -> bool:
    """Cycle detection over the channel dependency graph (iterative DFS)."""
    adj: dict[Link, list[Link]] = {}
    for a, b in deps:
        adj.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[Link, int] = {}
    for start in adj:
        if color.get(start, WHITE) != WHITE:
            continue
        stack: list[tuple[Link, int]] = [(start, 0)]
        color[start] = GREY
        while stack:
            node, i = stack.pop()
            nbrs = adj.get(node, ())
            if i < len(nbrs):
                stack.append((node, i + 1))
                nxt = nbrs[i]
                c = color.get(nxt, WHITE)
                if c == GREY:
                    return True
                if c == WHITE:
                    color[nxt] = GREY
                    stack.append((nxt, 0))
            else:
                color[node] = BLACK
    return False


def deadlock_free(policy, mesh: Mesh2D) -> bool:
    """True iff every route class of ``policy`` has an acyclic CDG.

    A multi-class policy (O1TURN) is reported deadlock-free when each
    class is individually acyclic — the classes must then be mapped to
    disjoint virtual networks, which
    :func:`min_vcs_for_deadlock_freedom` quantifies.
    """
    return all(
        not has_cycle(policy_dependencies(policy, mesh, route_class=c))
        for c in range(policy.route_classes)
    )


def min_vcs_for_deadlock_freedom(policy, mesh: Mesh2D) -> int:
    """VCs needed for freedom: 1 if the full turn set is acyclic, else
    the number of (individually acyclic) route classes."""
    if not has_cycle(policy_dependencies(policy, mesh)):
        return 1
    if not deadlock_free(policy, mesh):
        raise ValueError(
            f"policy {policy.name!r} has a cyclic route class on "
            f"{mesh.cols}x{mesh.rows}: not deadlock-free at any VC count"
        )
    return policy.route_classes


def turn_name(dep: tuple[Link, Link]) -> str:
    """Human-readable turn label, e.g. ``'EN@(2,3)'`` (straights: ``'EE@..'``)."""
    (a, b), (b2, c) = dep
    d1, d2 = _DIR_NAMES[_link_dir((a, b))], _DIR_NAMES[_link_dir((b2, c))]
    return f"{d1}{d2}@({b.x},{b.y})"
