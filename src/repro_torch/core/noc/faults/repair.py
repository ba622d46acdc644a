"""Fault-aware route repair: detours around dead links/routers that stay
deadlock-free.

**The detour rule.**  A unicast whose base-policy route crosses a dead
element is re-routed by a breadth-first search over *router states*
``(node, in_dir)`` that only expands turns the odd-even turn model
admits (Chiu 2000: EN/ES turns forbidden at even columns, NW/SW turns
forbidden at odd columns) and never makes a 180° turn.  Two properties
make this the right substrate:

* the odd-even turn set is acyclic *independently of the route set* —
  the theorem covers non-minimal paths, so detours of any shape obey it;
* searching over ``(node, in_dir)`` states means a shortest path never
  repeats a state, hence never repeats a *directed link* — exactly the
  invariant the simulator's beat-chain expansion needs (a route may
  revisit a router, but never a channel).

**The escape-VC argument** (the carried ROADMAP item).  Every stream in
this simulator occupies exactly one VC for its whole lifetime, so
channel-dependency cycles are intra-VC.  Base-policy routes on their own
VCs are deadlock-free by the policy's turn model
(:func:`fast_min_vcs`); detoured routes obey the odd-even turn model,
which is acyclic — but the *union* of a base turn set and the odd-even
set can be cyclic (e.g. XY's EN@even-column plus odd-even's
NW@even-column closes a cycle).  So when ``num_vcs`` affords it
(``num_vcs >= fast_min_vcs(policy) + 1``), detoured unicasts are placed
on a dedicated **escape VC** (the highest index, :func:`escape_vc`) where
only odd-even-legal routes ever live: each VC's turn set is then acyclic
and the degraded run is provably deadlock-free.  When ``num_vcs`` is too
small for the structural argument, the simulator falls back to the exact
``turns.py``-style check over the routes *actually used*
(:func:`verify_route_deps`) and raises :class:`RepairDeadlockError` with
the policy, the configured VC count, and the VC count that would have
sufficed.

:func:`fast_min_vcs` is the structural O(nodes) counterpart of the
all-pairs ``turns.min_vcs_for_deadlock_freedom`` (which enumerates every
route and is intractable past ~16x16): it builds each policy's *turn
superset* per node and cycle-checks that — the two agree exactly on
every shipped policy (xy/yx/oddeven -> 1, o1turn -> 2; asserted in
tests).
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional, Sequence

from repro_torch.core.noc.faults.model import FaultDisconnectedError, FaultSet
from repro_torch.core.noc.routing.policies import E, N, RoutingPolicy, S, W, get_policy
from repro_torch.core.noc.routing.turns import (
    has_cycle,
    min_vcs_for_deadlock_freedom,
    route_turns,
    turn_name,
)
from repro_torch.core.topology import Coord, Mesh2D

Link = tuple[Coord, Coord]
_DIRS = (E, W, N, S)


class RepairDeadlockError(RuntimeError):
    """No deadlock-free repair exists at the configured VC count."""


# ---------------------------------------------------------------------------
# Odd-even-legal detours.
# ---------------------------------------------------------------------------


def _oddeven_legal(node: Coord, d1: Optional[tuple[int, int]],
                   d2: tuple[int, int]) -> bool:
    """Is the turn ``in d1 -> out d2`` at ``node`` odd-even legal?

    ``d1 is None`` models injection (a fresh packet may leave in any
    direction).  180° turns are always forbidden — required for the
    turn-model acyclicity theorem to cover non-minimal routes.
    """
    if d1 is None:
        return True
    if d2 == (-d1[0], -d1[1]):
        return False
    if d1 == E and d2 in (N, S) and node.x % 2 == 0:
        return False  # EN/ES forbidden at even columns
    if d1 in (N, S) and d2 == W and node.x % 2 == 1:
        return False  # NW/SW forbidden at odd columns
    return True


@functools.lru_cache(maxsize=65536)
def detour_route(mesh: Mesh2D, faults: FaultSet, src: Coord, dst: Coord,
                 parity: int = 0) -> tuple[Coord, ...]:
    """Shortest odd-even-legal route from ``src`` to ``dst`` over healthy
    links only.  Deterministic: BFS with a fixed direction order
    (rotated by ``parity`` so the two packet classes spread load), first
    arrival wins.  Raises :class:`FaultDisconnectedError` when a dead
    endpoint or a partition makes the pair unreachable.

    Boundary corner: the odd-even model forbids NW/SW turns at odd
    columns, so a westbound packet walled off in the last (odd) column
    can be reachable yet have no odd-even-legal route.  Such pairs fall
    back to the unconstrained healthy-path BFS; the fallback route loses
    the structural escape-VC guarantee, but the exact per-VC
    channel-dependency check (:func:`verify_route_deps`, run before
    every degraded simulation) remains the authoritative deadlock gate
    and raises :class:`RepairDeadlockError` if the relaxed turn actually
    closes a cycle in the route set in use.
    """
    for c, role in ((src, "source"), (dst, "destination")):
        if faults.router_is_dead(c):
            raise FaultDisconnectedError(
                f"{role} ({c.x},{c.y}) is a dead router "
                f"({faults.describe()}): destination unreachable under "
                "current faults")
    if src == dst:
        return (src,)
    order = _DIRS[parity % 2:] + _DIRS[:parity % 2]
    start = (src, None)
    parent: dict[tuple, tuple] = {start: None}
    frontier = [start]
    while frontier:
        nxt: list[tuple] = []
        for state in frontier:
            node, d1 = state
            for d2 in order:
                if not _oddeven_legal(node, d1, d2):
                    continue
                n = Coord(node.x + d2[0], node.y + d2[1])
                if not mesh.contains(n) or faults.link_is_dead(node, n):
                    continue
                ns = (n, d2)
                if ns in parent:
                    continue
                parent[ns] = state
                if n == dst:
                    path = [n]
                    s = state
                    while s is not None:
                        path.append(s[0])
                        s = parent[s]
                    return tuple(reversed(path))
                nxt.append(ns)
        frontier = nxt
    # Reachable but not odd-even-routable (see docstring): relax the
    # turn discipline rather than fail a connected pair.  healthy_path
    # raises the partition diagnostic if the pair truly is cut off.
    return healthy_path(mesh, faults, src, dst)


@functools.lru_cache(maxsize=65536)
def healthy_path(mesh: Mesh2D, faults: FaultSet, src: Coord,
                 dst: Coord) -> tuple[Coord, ...]:
    """Shortest plain-BFS path over healthy links (no turn constraints) —
    the route primitive for collective-tree re-grafting, where validity
    invariants (one parent / one output), not the unicast CDG, are the
    correctness contract.  Deterministic via fixed direction order."""
    for c, role in ((src, "source"), (dst, "destination")):
        if faults.router_is_dead(c):
            raise FaultDisconnectedError(
                f"tree {role} ({c.x},{c.y}) is a dead router "
                f"({faults.describe()})")
    if src == dst:
        return (src,)
    parent: dict[Coord, Coord] = {src: src}
    frontier = [src]
    while frontier:
        nxt: list[Coord] = []
        for node in frontier:
            for d in _DIRS:
                n = Coord(node.x + d[0], node.y + d[1])
                if (not mesh.contains(n) or faults.link_is_dead(node, n)
                        or n in parent):
                    continue
                parent[n] = node
                if n == dst:
                    path = [n]
                    while path[-1] != src:
                        path.append(parent[path[-1]])
                    return tuple(reversed(path))
                nxt.append(n)
        frontier = nxt
    raise FaultDisconnectedError(
        f"no healthy path ({src.x},{src.y})->({dst.x},{dst.y}) on "
        f"{mesh.cols}x{mesh.rows}: fault pattern disconnects the pair "
        f"({faults.describe()})")


def route_is_healthy(faults: FaultSet, path: Sequence[Coord]) -> bool:
    if any(faults.router_is_dead(c) for c in path):
        return False
    return not any(faults.link_is_dead(a, b) for a, b in zip(path, path[1:]))


@functools.lru_cache(maxsize=65536)
def _repaired_route_cached(
    policy_name: str, mesh: Mesh2D, faults: FaultSet, src: Coord,
    dst: Coord, parity: int,
) -> tuple[tuple[Coord, ...], bool]:
    policy = get_policy(policy_name)
    base = policy.route(mesh, src, dst, parity)
    if route_is_healthy(faults, base):
        return base, False
    return detour_route(mesh, faults, src, dst, parity), True


def repair_route(
    mesh: Mesh2D, faults: FaultSet, policy: RoutingPolicy | str, src: Coord,
    dst: Coord, packet_id: int = 0,
) -> tuple[tuple[Coord, ...], bool]:
    """The unicast route under ``faults``: the base-policy route when it
    is fully healthy, else an odd-even-legal detour.  Returns
    ``(path, detoured)``.  Every shipped policy's route depends on
    ``packet_id`` only through its parity, so results are memoized on
    ``packet_id % 2``."""
    name = policy if isinstance(policy, str) else policy.name
    return _repaired_route_cached(name, mesh, faults, src, dst,
                                  packet_id % 2)


# ---------------------------------------------------------------------------
# Structural min-VC check: O(nodes) turn supersets per policy.
# ---------------------------------------------------------------------------


def _xy_turns(node: Coord):
    for d in _DIRS:
        yield d, d
    for d1 in (E, W):
        for d2 in (N, S):
            yield d1, d2


def _yx_turns(node: Coord):
    for d in _DIRS:
        yield d, d
    for d1 in (N, S):
        for d2 in (E, W):
            yield d1, d2


def _oddeven_turns(node: Coord):
    for d1 in _DIRS:
        for d2 in _DIRS:
            if _oddeven_legal(node, d1, d2):
                yield d1, d2


# Per-policy, per-route-class turn generators.  A policy absent from this
# table falls back to the exact all-pairs enumeration in turns.py.
_STRUCTURAL: dict[str, tuple] = {
    "xy": (_xy_turns,),
    "yx": (_yx_turns,),
    "o1turn": (_xy_turns, _yx_turns),
    "oddeven": (_oddeven_turns,),
}


def turn_superset(policy_name: str, mesh: Mesh2D,
                  route_class: Optional[int] = None) -> set[tuple[Link, Link]]:
    """Every link-to-link dependency the policy *could* generate, built
    per node from its turn rules in O(nodes) — a superset of the
    all-pairs enumeration in :func:`turns.policy_dependencies`, with the
    same acyclicity verdict on every shipped policy."""
    gens = _STRUCTURAL[policy_name]
    if route_class is not None:
        gens = (gens[route_class],)
    deps: set[tuple[Link, Link]] = set()
    for gen in gens:
        for b in mesh.coords():
            for d1, d2 in gen(b):
                a = Coord(b.x - d1[0], b.y - d1[1])
                c = Coord(b.x + d2[0], b.y + d2[1])
                if mesh.contains(a) and mesh.contains(c):
                    deps.add(((a, b), (b, c)))
    return deps


@functools.lru_cache(maxsize=256)
def fast_min_vcs(policy_name: str, mesh: Mesh2D) -> int:
    """VCs needed for deadlock freedom, via structural turn supersets —
    tractable at any mesh size, agreeing exactly with the enumerated
    ``min_vcs_for_deadlock_freedom`` on every shipped policy."""
    if policy_name not in _STRUCTURAL:
        return min_vcs_for_deadlock_freedom(get_policy(policy_name), mesh)
    if not has_cycle(turn_superset(policy_name, mesh)):
        return 1
    classes = len(_STRUCTURAL[policy_name])
    for c in range(classes):
        if has_cycle(turn_superset(policy_name, mesh, route_class=c)):
            raise ValueError(
                f"policy {policy_name!r} has a cyclic route class on "
                f"{mesh.cols}x{mesh.rows}: not deadlock-free at any VC count")
    return classes


def escape_vc(policy_name: str, mesh: Mesh2D, num_vcs: int) -> Optional[int]:
    """The dedicated escape VC for detoured unicasts — the highest VC
    index — when ``num_vcs`` affords one beyond the policy's structural
    minimum; ``None`` when it does not (the exact per-workload check
    then gates the run)."""
    if num_vcs >= fast_min_vcs(policy_name, mesh) + 1:
        return num_vcs - 1
    return None


# ---------------------------------------------------------------------------
# Exact verification of repaired route sets.
# ---------------------------------------------------------------------------


def route_set_deps(routes: Iterable[Sequence[Coord]]) -> set[tuple[Link, Link]]:
    """The exact channel-dependency set of a concrete route collection."""
    deps: set[tuple[Link, Link]] = set()
    for path in routes:
        deps.update(route_turns(path))
    return deps


def verify_route_deps(
    deps_by_vc: dict[int, set[tuple[Link, Link]]],
    policy_name: str, mesh: Mesh2D, num_vcs: int,
) -> None:
    """Exact per-VC CDG check over the routes a workload actually uses.

    Streams hold one VC for life, so cycles are intra-VC: each VC's
    dependency set must be acyclic on its own.  Raises
    :class:`RepairDeadlockError` naming the cyclic VC, a witness turn
    that actually lies on a cycle, and — when raising the VC count would
    admit the structural escape-VC repair — the count that would.
    """
    for vc, deps in sorted(deps_by_vc.items()):
        if not has_cycle(deps):
            continue
        # Trim deps that cannot lie on a cycle (their source channel has
        # no incoming dep, or their target no outgoing) until a fixpoint;
        # what survives is the cyclic core, so the witness is honest.
        core = set(deps)
        while True:
            srcs = {a for a, _ in core}
            dsts = {b for _, b in core}
            trimmed = {d for d in core if d[0] in dsts and d[1] in srcs}
            if trimmed == core:
                break
            core = trimmed
        witness = min(core, key=lambda d: (tuple(d[0][0]), tuple(d[0][1])))
        need = fast_min_vcs(policy_name, mesh) + 1
        if num_vcs < need:
            hint = (f"configure num_vcs >= {need} so detoured routes get "
                    "a dedicated escape VC")
        else:
            hint = ("the cycle involves relaxed-turn fallback detours "
                    "(pairs unroutable under odd-even rules, e.g. walled "
                    "off in the last column); this fault pattern has no "
                    "deadlock-free repair at the configured VC count")
        raise RepairDeadlockError(
            f"repaired route set has a cyclic channel dependency on VC "
            f"{vc} (policy {policy_name!r}, num_vcs={num_vcs}, e.g. turn "
            f"{turn_name(witness)} on the cycle): no deadlock-free repair "
            f"at this VC count — {hint}")


def verify_repair(
    mesh: Mesh2D, faults: FaultSet, policy: RoutingPolicy | str,
    pairs: Iterable[tuple[Coord, Coord]], num_vcs: int = 2,
) -> dict[int, set[tuple[Link, Link]]]:
    """Repair every (src, dst) pair and exactly verify the result under
    the escape-VC placement: base routes on VC ``route_class``, detours
    on the escape VC (or VC 0 when ``num_vcs`` affords none — in which
    case a mixed cyclic set raises).  Returns the per-VC dependency sets
    on success; used by the property tests and benches."""
    policy = get_policy(policy) if isinstance(policy, str) else policy
    esc = escape_vc(policy.name, mesh, num_vcs)
    deps_by_vc: dict[int, set[tuple[Link, Link]]] = {}
    for pid, (src, dst) in enumerate(pairs):
        path, detoured = repair_route(mesh, faults, policy, src, dst, pid)
        if detoured and esc is not None:
            vc = esc
        else:
            vc = policy.route_class(pid) % max(num_vcs, 1)
        deps_by_vc.setdefault(vc, set()).update(route_turns(path))
    verify_route_deps(deps_by_vc, policy.name, mesh, num_vcs)
    return deps_by_vc
